"""Serving fan-out: one front door over N servers (port of ``zonos_tpu/serving/router.py``).

Within a server, requests coalesce onto the batch axis (serving/batcher.py,
serving/continuous.py); across servers, scaling is plain request routing.
This router is a stdlib reverse proxy that load-balances /generate and
/stream across backend servers with passive health checking. It holds no
model.

    python -m zonos_tpu_torch.serving.router --port 7900 \
        --backend http://host-a:7911 --backend http://host-b:7911

Design notes:
* least-outstanding-requests balancing — decode latency is dominated by
  each host's batch occupancy, so the least-busy host is the one whose
  batcher will coalesce the request soonest;
* /stream proxies chunk-by-chunk (chunked transfer in, chunked out) so
  TTFA through the router adds only one hop;
* a backend that errors or refuses connections is quarantined for
  ``cooldown_s`` and retried passively;
* GET endpoints (/health /models /conditioners /ui_spec /) proxy to any
  healthy backend.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class BackendPool:
    """Least-outstanding-requests pool with passive quarantine."""

    def __init__(self, urls: list[str], cooldown_s: float = 10.0):
        assert urls, "need at least one --backend"
        self.urls = list(urls)
        self.cooldown_s = cooldown_s
        self._lock = threading.Lock()
        self._outstanding = {u: 0 for u in urls}
        self._down_until = {u: 0.0 for u in urls}
        self._rr = 0  # tie-breaker: rotate among equally-loaded backends

    def acquire(self) -> str | None:
        """Pick the healthy backend with the fewest outstanding requests."""
        now = time.monotonic()
        with self._lock:
            healthy = [u for u in self.urls if self._down_until[u] <= now]
            if not healthy:
                return None
            lo = min(self._outstanding[u] for u in healthy)
            candidates = [u for u in healthy if self._outstanding[u] == lo]
            url = candidates[self._rr % len(candidates)]
            self._rr += 1
            self._outstanding[url] += 1
            return url

    def release(self, url: str, ok: bool) -> None:
        with self._lock:
            self._outstanding[url] = max(0, self._outstanding[url] - 1)
            if not ok:
                self._down_until[url] = time.monotonic() + self.cooldown_s

    def healthy_urls(self) -> list[str]:
        now = time.monotonic()
        with self._lock:
            return [u for u in self.urls if self._down_until[u] <= now]

    def quarantine(self, url: str) -> None:
        """Mark a backend down without touching its outstanding count."""
        with self._lock:
            self._down_until[url] = time.monotonic() + self.cooldown_s

    def stats(self) -> dict:
        now = time.monotonic()
        with self._lock:
            return {
                "backends": [
                    {
                        "url": u,
                        "outstanding": self._outstanding[u],
                        "healthy": self._down_until[u] <= now,
                    }
                    for u in self.urls
                ]
            }


def aggregate_metrics(texts: list[str]) -> str:
    """Merge Prometheus text pages from N backends into one fleet view.

    Every zonos series is summable across instances: counters add, and
    histogram _bucket/_sum/_count samples add bucket-wise (serving/metrics.py
    emits fixed buckets, so same-name series share bucket bounds). HELP/TYPE
    headers are kept once, first occurrence wins.
    """
    order: list[str] = []  # sample keys in first-seen order
    sums: dict[str, float] = {}
    meta: list[str] = []
    meta_seen: set[str] = set()
    for text in texts:
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            if line.startswith("#"):
                # "# TYPE <name> <kind>" / "# HELP <name> ..." — dedup by
                # the first two tokens after '#'.
                parts = line.split(None, 3)
                key = " ".join(parts[:3])
                if key not in meta_seen:
                    meta_seen.add(key)
                    meta.append(line)
                continue
            series, _, value = line.rpartition(" ")
            try:
                v = float(value)
            except ValueError:
                continue
            if series not in sums:
                sums[series] = 0.0
                order.append(series)
            sums[series] += v
    out = meta + [f"{s} {sums[s]:g}" for s in order]
    return "\n".join(out) + "\n"


def make_handler(pool: BackendPool, timeout_s: float = 600.0):
    class RouterHandler(BaseHTTPRequestHandler):
        server_version = "ZonosTorchRouter/0.1"

        def log_message(self, fmt, *args):  # quiet
            pass

        def _proxy(self, method: str):
            body = None
            if method == "POST":
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n) if n else b""
            url = pool.acquire()
            if url is None:
                payload = json.dumps({"error": "no healthy backends"}).encode()
                self.send_response(503)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)
                return
            ok = False

            class _ClientGone(Exception):
                """Our CLIENT's socket failed mid-response (disconnect,
                broken pipe). The backend answered fine — attributing this
                to the backend would quarantine a healthy node on every
                client abort of a long /stream."""

            def cw(fn, *a):
                # Client-side write: OSError here means the client hung up.
                try:
                    return fn(*a)
                except OSError as e:
                    raise _ClientGone from e

            try:
                req = urllib.request.Request(url + self.path, data=body, method=method)
                for h in ("Content-Type",):
                    if self.headers.get(h):
                        req.add_header(h, self.headers[h])
                with urllib.request.urlopen(req, timeout=timeout_s) as resp:
                    cw(self.send_response, resp.status)
                    chunked = resp.headers.get("Transfer-Encoding") == "chunked"
                    for h, v in resp.headers.items():
                        if h.lower() in ("date", "server", "transfer-encoding", "content-length"):
                            continue
                        cw(self.send_header, h, v)
                    if chunked:
                        # Stream through chunk-by-chunk: TTFA adds one hop.
                        cw(self.send_header, "Transfer-Encoding", "chunked")
                        cw(self.end_headers)
                        while True:
                            # What the backend has sent, up to 32 KB: read()
                            # would wait for a full 32 KB, holding back the
                            # first PCM chunk (16 KB at 16 frames) until the next.
                            chunk = resp.read1(32768)  # backend-side read
                            if not chunk:
                                break
                            cw(self.wfile.write, f"{len(chunk):x}\r\n".encode())
                            cw(self.wfile.write, chunk)
                            cw(self.wfile.write, b"\r\n")
                            cw(self.wfile.flush)
                        cw(self.wfile.write, b"0\r\n\r\n")
                    else:
                        data = resp.read()  # backend-side read
                        cw(self.send_header, "Content-Length", str(len(data)))
                        cw(self.end_headers)
                        cw(self.wfile.write, data)
                    ok = True
            except _ClientGone:
                ok = True  # backend healthy; the requester went away
            except urllib.error.HTTPError as e:
                # The backend ANSWERED (4xx client error, 5xx handler error):
                # relay its response verbatim; this is not a dead backend —
                # quarantining here would take the fleet down on one bad
                # request (e.g. an unknown speaker name → 400).
                data = e.read()
                try:
                    self.send_response(e.code)
                    self.send_header(
                        "Content-Type", e.headers.get("Content-Type", "application/json")
                    )
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                except OSError:
                    pass
                ok = True
            except (urllib.error.URLError, ConnectionError, TimeoutError, OSError) as e:
                payload = json.dumps({"error": f"backend {url} failed: {e}"}).encode()
                try:
                    self.send_response(502)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                except OSError:
                    pass
            finally:
                pool.release(url, ok)

        def do_GET(self):
            if self.path == "/metrics":
                # Fleet aggregate: sum every backend's Prometheus page
                # (counters and fixed-bucket histograms are all summable).
                texts = []
                for u in pool.healthy_urls():
                    try:
                        with urllib.request.urlopen(u + "/metrics", timeout=10.0) as r:
                            texts.append(r.read().decode())
                    except (urllib.error.URLError, ConnectionError, TimeoutError, OSError):
                        pool.quarantine(u)
                payload = aggregate_metrics(texts).encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)
                return
            if self.path == "/router_stats":
                payload = json.dumps(pool.stats()).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)
                return
            self._proxy("GET")

        def do_POST(self):
            if self.path in ("/lexicon", "/speakers"):
                # Admin ops are idempotent: broadcast to every healthy
                # backend so pronunciation overrides and uploaded voices
                # stay fleet-consistent.
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                results, ok, reached = [], 0, 0
                for u in pool.healthy_urls():
                    try:
                        req = urllib.request.Request(
                            u + self.path, data=body, method="POST",
                            headers={"Content-Type": "application/json"},
                        )
                        with urllib.request.urlopen(req, timeout=30.0) as r:
                            results.append(json.loads(r.read()))
                            ok += 1
                            reached += 1
                    except urllib.error.HTTPError as e:
                        # Backend answered with an error status (bad
                        # payload etc.) — healthy, just unhappy.
                        reached += 1
                        try:
                            results.append(json.loads(e.read()))
                        except Exception:
                            results.append({"error": f"HTTP {e.code}"})
                    except (urllib.error.URLError, ConnectionError,
                            TimeoutError, OSError) as e:
                        results.append({"error": str(e)})
                        pool.quarantine(u)
                payload = json.dumps(
                    {"backends_ok": ok, "results": results}
                ).encode()
                # 502 only when NO backend was even reachable; backends that
                # answered (incl. 4xx rejections) keep this a 200 with
                # per-backend results.
                self.send_response(200 if reached else 502)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)
                return
            self._proxy("POST")

    return RouterHandler


def main():
    ap = argparse.ArgumentParser(description="Multi-host zonos serving router")
    ap.add_argument("--port", type=int, default=7900)
    ap.add_argument("--backend", action="append", required=True,
                    help="backend base URL (repeatable)")
    ap.add_argument("--cooldown", type=float, default=10.0)
    args = ap.parse_args()
    pool = BackendPool(args.backend, cooldown_s=args.cooldown)
    srv = ThreadingHTTPServer(("0.0.0.0", args.port), make_handler(pool))
    print(f"router on :{args.port} → {args.backend}")
    srv.serve_forever()


if __name__ == "__main__":
    main()
