"""HTTP clients of the load generator, in the harness's own process.

``stream`` and ``generate`` send one request and time it on the host clock
(``time.perf_counter``); ``open_loop`` sends each request at its due time from
a thread of its own, ``closed_loop`` one after another from this thread.
"""

from __future__ import annotations

import http.client
import io
import json
import threading
import time
import wave


def post_json(port: int, path: str, body: dict, timeout: float = 600.0) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        if resp.status != 200:
            raise RuntimeError(f"{path}: HTTP {resp.status}: {data[:200]!r}")
        return json.loads(data)
    finally:
        conn.close()


def get_ok(port: int, path: str, timeout: float = 2.0) -> bool:
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
        conn.request("GET", path)
        ok = conn.getresponse().status == 200
        conn.close()
        return ok
    except OSError:
        return False


def _result(rid: int, due: float) -> dict:
    return {"id": rid, "due": due, "sent": None, "first": None, "last": None, "pcm": b"", "chunks": [],
            "sr": 44100, "error": None}


def stream(port: int, body: dict, out: dict, timeout: float) -> None:
    """POST /stream; records the send time, the first and last PCM bytes' arrival and the PCM."""
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
        out["sent"] = time.perf_counter()
        conn.request("POST", "/stream", json.dumps(body), {"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            out["error"] = f"HTTP {resp.status}: {resp.read()[:200]!r}"
            return
        out["sr"] = int(resp.getheader("X-Sample-Rate", "44100"))
        parts = []
        while True:
            data = resp.read1(1 << 20)
            if not data:
                break
            now = time.perf_counter()
            if out["first"] is None:
                out["first"] = now
            out["last"] = now
            parts.append(data)
        out["pcm"] = b"".join(parts)
        conn.close()
        if not out["pcm"]:
            out["error"] = "empty stream"
    except Exception as e:  # noqa: BLE001 - every failure is a failed request
        out["error"] = repr(e)


def generate(port: int, body: dict, out: dict, timeout: float) -> None:
    """POST /generate; the whole WAV arrives at once."""
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
        out["sent"] = time.perf_counter()
        conn.request("POST", "/generate", json.dumps(body), {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        now = time.perf_counter()
        conn.close()
        if resp.status != 200:
            out["error"] = f"HTTP {resp.status}: {data[:200]!r}"
            return
        with wave.open(io.BytesIO(data)) as w:
            out["sr"] = w.getframerate()
            out["pcm"] = w.readframes(w.getnframes())
        out["first"] = out["last"] = now
    except Exception as e:  # noqa: BLE001
        out["error"] = repr(e)


def open_loop(port: int, requests, bodies: list, t0: float, cap_s: float, on_tick=None) -> list:
    """Each request sent at t0 + due by its own thread; returns once every one
    has ended or its cap (due + cap_s) has passed; unfinished ones fail."""
    results = [_result(r.index, t0 + r.due) for r in requests]

    def one(i):
        delay = results[i]["due"] - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        stream(port, bodies[i], results[i], timeout=cap_s)

    threads = [threading.Thread(target=one, args=(i,), daemon=True) for i in range(len(requests))]
    for t in threads:
        t.start()
    deadline = max(r["due"] for r in results) + cap_s
    while any(t.is_alive() for t in threads) and time.perf_counter() < deadline:
        if on_tick:
            on_tick()
        time.sleep(0.05)
    for t, r in zip(threads, results):
        if t.is_alive():
            r["error"] = r["error"] or "unfinished at the cap"
    return results


def closed_loop(port: int, requests, bodies: list, t0: float, seconds: float, cap_s: float, on_tick=None,
                keep_going=None) -> list:
    """Requests one after another from t0 while the window is open, or while
    ``keep_going()`` holds after it; the last one started is followed to its
    end."""
    results = []
    for r, body in zip(requests, bodies):
        now = time.perf_counter()
        if now - t0 >= seconds and not (keep_going and keep_going()):
            break
        res = _result(r.index, now)
        th = threading.Thread(target=generate, args=(port, body, res, cap_s), daemon=True)
        th.start()
        while th.is_alive():
            if on_tick:
                on_tick()
            th.join(0.05)
        results.append(res)
    return results
