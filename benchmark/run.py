"""The port's benchmark: one cell of ``BENCHMARK.json``, one run.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up: the server (``zonos_tpu_torch.serving.server`` through the wrapper
``benchmark.serve``) starts in a child process on the card, with the weights
made from the seed and the cell's server mode, and warms up as it is
deployed (``--warmup``); a fleet cell starts one on each card behind the
program's router (``Fleet``). ``setup_s`` runs from this process's start to the
window's opening. The window: the cell's traffic mix (``benchmark.traffic``)
for ``--seconds`` seconds, an open loop of ``/stream`` requests or a closed
loop of ``/generate`` requests from this process; every request due in the
window is followed to its end, up to the mix's cap. Then the server stops,
the reference checks the greedy requests (``benchmark.check``), and the last
line of standard output is the result. With ``--trace 1`` the wrapper profiles
a slice at the end of the window (a fleet's first backend alone) and the
per-layer metrics are read from it (``benchmark/metrics``).

``--control 1`` also reads the control (int4 weights and KV, fp8 codec) on
the same served requests, judges it by the same expression as ``correct``
and prints both on an earlier line (``control_correct`` has to come out
false); the benchmark's own runs never ask for it. ``--config-file`` and ``--platform cpu`` are for the CPU
rehearsal of the tests.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import signal  # noqa: E402
import socket  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from concurrent.futures import ThreadPoolExecutor  # noqa: E402

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
# Run as a script, this directory heads sys.path: the repo's root takes its place.
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
sys.path.insert(0, REPO)

from benchmark import client, isolation, spec, traffic  # noqa: E402
from benchmark.tracedata import Context  # noqa: E402

PROGRAM = "zonos_tpu_torch"
START_TIMEOUT_S = 1100.0
# The most greedy requests the reference checks in a run (every one where a
# cell serves fewer).
CHECK_REQUESTS = 32


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def p90(values: list) -> float:
    """The 90th percentile, interpolated between order statistics."""
    if len(values) == 1:
        return float(values[0])
    return float(statistics.quantiles(values, n=10, method="inclusive")[8])


def end_to_end(results: list, cap_s: float, seconds: float, t0: float, loop: str) -> dict:
    """Each end-to-end metric the mix can give, from the client's records.
    A failed or unfinished request counts at the cap: its TTFA and its stall
    are the cap, and it streams for the cap with no audio.
    ``stream_s_per_audio_s`` is the seconds from first to last byte over the
    seconds of audio, summed over every request: above 1, a player that starts
    at the first byte waits that much minus 1 for each second it plays.
    ``stall_p90_ms`` (each request's wait for audio that has not arrived) is
    printed only: it spreads too widely between runs to hold a bound."""
    cap_ms = cap_s * 1e3
    ttfa, stall, audio, streamed = [], [], 0.0, 0.0
    for r in results:
        if r["error"] or r["first"] is None:
            ttfa.append(cap_ms)
            stall.append(cap_ms)
            streamed += cap_s
            continue
        dur = len(r["pcm"]) / 2 / r["sr"]
        audio += dur
        streamed += r["last"] - r["first"]
        ttfa.append((r["first"] - r["due"]) * 1e3)
        stall.append(max((r["last"] - r["first"]) - dur, 0.0) * 1e3)
    out = {}
    if loop == "open":
        out["ttfa_p90_ms"] = p90(ttfa)
        out["stall_p90_ms"] = p90(stall)
        if audio > 0:
            out["stream_s_per_audio_s"] = streamed / audio
        out["audio_s_per_s"] = audio / seconds
    else:
        ends = [r["last"] for r in results if r["last"] is not None]
        out["rtf_solo"] = audio / ((max(ends) if ends else t0 + seconds) - t0)
    return out


def judge(token_gap: float, pcm_err: float, unmatched: int, other_weights: int, requests: int, limits: dict) -> bool:
    """``correct``: every compared number within its limit (every backend
    served the weights that the reference makes again)."""
    return (token_gap <= limits["token_gap"] and pcm_err <= limits["pcm_err"] and unmatched == 0
            and other_weights == 0 and requests >= 1)


def check_sample(served: dict, backend_of: dict, seed: int) -> list:
    """The served greedy requests the reference checks: all of them, or
    ``CHECK_REQUESTS`` drawn from the seed with the longest of all and each
    backend's longest among them."""
    ids = sorted(served, key=int)
    n = CHECK_REQUESTS
    if len(ids) <= n:
        return ids
    longest = sorted(ids, key=lambda i: (-len(served[i]["codes"][0]), int(i)))
    pick = []
    for i in longest:
        if backend_of.get(int(i)) not in {backend_of.get(int(j)) for j in pick}:
            pick.append(i)
    rest = [i for i in ids if i not in pick]
    rng = np.random.default_rng([int(seed) % (2**63), 11])
    pick += [rest[j] for j in rng.permutation(len(rest))[: max(n - len(pick), 0)]]
    return sorted(pick, key=int)


def built_libraries() -> set:
    """The program's compiled kernel libraries in its build cache."""
    d = os.path.join(REPO, PROGRAM, "build")
    return {f for f in os.listdir(d) if f.endswith(".so")} if os.path.isdir(d) else set()


def _stop(proc: subprocess.Popen) -> None:
    """SIGTERM to a child's whole session, SIGKILL after 30 s; waits for it."""
    if proc.poll() is None:
        for sig, wait in ((signal.SIGTERM, 30), (signal.SIGKILL, 60)):
            try:
                os.killpg(proc.pid, sig)
            except ProcessLookupError:
                break
            try:
                proc.wait(timeout=wait)
                break
            except subprocess.TimeoutExpired:
                continue
    try:
        os.killpg(proc.pid, signal.SIGKILL)  # anything the child left in its session
    except ProcessLookupError:
        pass


def _env(work: str) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in ("HF_HUB_CACHE", "ZONOS_PLATFORM", "ZONOS_TINY_MODEL",
                                                             "ZONOS_BATCHING", "ZONOS_MAX_BATCH")}
    env["HF_HOME"] = os.path.join(work, "hf")
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH")) if p)
    return env


class Server:
    """The wrapped server in a child process of its own session; ``card``
    pins it to one CUDA device (``CUDA_VISIBLE_DEVICES``)."""

    def __init__(self, cfg_path: str, seed: int, work: str, cell: dict, model_choice: str, trace: bool,
                 platform: str, fault: str, log_path: str, card: int | None = None):
        self.port, self.cport = _free_port(), _free_port()
        env = _env(work)
        env.update(cell.get("server_env", {}))
        if platform == "cpu":
            env["ZONOS_PLATFORM"] = "cpu"
        elif card is not None:
            # The card-th of the devices this process sees.
            visible = os.environ.get("CUDA_VISIBLE_DEVICES")
            env["CUDA_VISIBLE_DEVICES"] = visible.split(",")[card] if visible else str(card)
        cmd = [sys.executable, "-m", "benchmark.serve", "--config", cfg_path, "--seed", str(seed), "--work", work,
               "--control-port", str(self.cport), "--voices", str(cell.get("voices", 8))]
        if trace:
            cmd.append("--trace")
        if platform == "cpu":
            cmd += ["--platform", "cpu"]
        if fault:
            cmd += ["--fault", fault]
        cmd += ["--", "--server", "127.0.0.1", "--port", str(self.port), "--model", model_choice,
                *cell.get("server_args", [])]
        self.log_path = log_path
        self.log = open(log_path, "w")
        self.proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=self.log, stderr=subprocess.STDOUT,
                                     start_new_session=True)

    def wait_ready(self, timeout: float) -> None:
        t = time.perf_counter()
        while not client.get_ok(self.port, "/health"):
            if self.proc.poll() is not None:
                raise RuntimeError(f"the server exited with {self.proc.returncode}:\n{self.tail()}")
            if time.perf_counter() - t > timeout:
                raise RuntimeError(f"the server did not listen within {timeout:.0f} s:\n{self.tail()}")
            time.sleep(0.2)

    def control(self, path: str, body: dict | None = None, timeout: float = 600.0) -> dict:
        return client.post_json(self.cport, path, body or {}, timeout=timeout)

    def tail(self, n: int = 4000) -> str:
        self.log.flush()
        with open(self.log_path, errors="replace") as f:
            return f.read()[-n:]

    def stop(self) -> None:
        _stop(self.proc)
        self.log.close()


def _each(fn, items: list) -> list:
    """fn(item) for every item at once, one thread each; the results in order."""
    with ThreadPoolExecutor(max(len(items), 1)) as ex:
        return list(ex.map(fn, items))


class Fleet:
    """The cell's servers: one, served directly, or one on each of the cell's
    ``chips`` cards, in one working directory behind the program's router
    (``python -m zonos_tpu_torch.serving.router``, least outstanding
    requests), as docs/DEPLOYMENT.md serves a host with several cards. The
    load goes to ``port``; ``control`` asks every backend and returns their
    answers in order. Only the first backend is traced: the others replay
    their decode steps as untraced runs do."""

    def __init__(self, cfg_path: str, seed: int, work: str, cell: dict, model_choice: str, trace: bool,
                 platform: str, fault: str, work_root: str, n: int):
        kind, _, at = fault.partition("@")
        os.makedirs(work, exist_ok=True)
        self.backends, self.router = [], None
        try:
            for i in range(n):
                self.backends.append(Server(cfg_path, seed, work, cell, model_choice, trace and i == 0, platform,
                                            kind if at in ("", str(i)) else "",
                                            os.path.join(work_root, "server.log" if n == 1 else f"server{i}.log"),
                                            card=i if n > 1 else None))
            self.port = self.backends[0].port
            if n > 1:
                self.port = _free_port()
                self.router_log = open(os.path.join(work_root, "router.log"), "w")
                self.router = subprocess.Popen(
                    [sys.executable, "-m", f"{PROGRAM}.serving.router", "--port", str(self.port),
                     *[a for b in self.backends for a in ("--backend", f"http://127.0.0.1:{b.port}")]],
                    cwd=work, env=_env(work), stdout=self.router_log, stderr=subprocess.STDOUT, start_new_session=True)
        except BaseException:
            self.stop()
            raise

    def wait_ready(self, timeout: float) -> None:
        t = time.perf_counter()
        _each(lambda b: b.wait_ready(timeout), self.backends)
        while self.router is not None and not client.get_ok(self.port, "/router_stats"):
            if self.router.poll() is not None or time.perf_counter() - t > timeout:
                raise RuntimeError(f"the router did not listen:\n{self.tail()}")
            time.sleep(0.2)

    def control(self, path: str, body: dict | None = None, timeout: float = 600.0) -> list:
        return _each(lambda b: b.control(path, body, timeout), self.backends)

    def tail(self, n: int = 4000) -> str:
        tails = [b.tail(n) for b in self.backends]
        if self.router is not None:
            self.router_log.flush()
            with open(self.router_log.name, errors="replace") as f:
                tails.append("router:\n" + f.read()[-n:])
        return "\n".join(tails)

    def stop(self) -> None:
        if self.router is not None:
            _stop(self.router)
            self.router_log.close()
        _each(lambda b: b.stop(), self.backends)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--config-file", default=None)
    ap.add_argument("--platform", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--fault", default="")
    ap.add_argument("--rate", type=float, default=None)
    args = ap.parse_args(argv)

    import torch

    bench = spec.load()
    w = spec.workload(bench, args.workload)
    cell = spec.cell(args.workload)
    mix = spec.traffic(w["traffic"])
    cfg_path = args.config_file or spec.config_path(bench, w["config"])
    with open(cfg_path) as f:
        doc = json.load(f)
    if not os.path.isdir(os.path.join(REPO, PROGRAM)):
        _log(f"no {PROGRAM} package beside BENCHMARK.json: nothing to measure")
        return 2
    if args.platform == "cuda" and (not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]):
        _log(f"the cell needs {w['chips']} CUDA device(s); torch sees "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    device = torch.device("cpu" if args.platform == "cpu" else "cuda")

    work_root = os.path.join(os.environ.get("TMPDIR") or os.path.join(REPO, "benchmark_out"), "zonos-benchmark")
    work = os.path.join(work_root, "server")
    shutil.rmtree(work_root, ignore_errors=True)
    os.makedirs(work_root)
    n_backends = w["chips"]
    trace_path = os.path.join(work_root, "trace.json")

    rate = args.rate if args.rate is not None else cell.get("rate_rps")
    requests = traffic.make_requests(mix, args.seed, args.seconds, rate)
    bodies = [r.body(mix, doc["model_choice"]) for r in requests]
    libs_before = built_libraries()
    server = Fleet(cfg_path, args.seed, work, cell, doc["model_choice"], bool(args.trace), args.platform, args.fault,
                   work_root, n_backends)
    try:
        server.wait_ready(START_TIMEOUT_S)
        server.control("/bench/record")
        t0 = time.perf_counter()
        setup_s = t0 - T_START
        # A set-up that built kernel libraries is a first run in this checkout.
        built = sorted(built_libraries() - libs_before)
        _log(f"setup_s {setup_s:.3f} ({'built ' + ', '.join(built) if built else 'no library built'}); "
             f"{len(requests)} requests queued; rate {rate} req/s")
        slice_s = cell.get("trace_slice_s", 3)
        # The slice closes a second before the window does: the profiler leaves the
        # host slower for the rest of the process, which then only drains.
        prof = {"start": t0 + max(args.seconds - slice_s - 1, 0), "state": 0}

        def tick():
            # The slice is timed from when the profiler has started: the
            # server's control thread may answer late under load.
            if not args.trace or prof["state"] == 2:
                return
            now = time.perf_counter()
            if prof["state"] == 0 and now >= prof["start"]:
                prof["asked"] = now
                server.backends[0].control("/bench/profile/start")
                prof["state"], prof["stop"] = 1, time.perf_counter() + slice_s
            elif prof["state"] == 1 and now >= prof["stop"]:
                server.backends[0].control("/bench/profile/stop")
                prof["state"] = 2

        if mix["loop"] == "open":
            results = client.open_loop(server.port, requests, bodies, t0, mix["cap_s"], tick)
        else:
            # A traced run sends on until its slice has closed: the profiler
            # can take seconds to start under a request, and a slice that
            # outlasts the last request would time an idle server.
            results = client.closed_loop(server.port, requests, bodies, t0, args.seconds, mix["cap_s"], tick,
                                         (lambda: prof["state"] != 2) if args.trace else None)
        if prof["state"] == 1:
            server.backends[0].control("/bench/profile/stop")
        late = [r["sent"] - r["due"] for r in results if r["sent"] is not None]
        by_id = {r["id"]: r for r in results}
        reqs = {r.index: r for r in requests}
        greedy = [r["id"] for r in results if reqs[r["id"]].greedy and not r["error"]]
        reports = _each(lambda ib: ib[1].control("/bench/report", {
            "ids": greedy, "trace": trace_path if args.trace and ib[0] == 0 else None}),
                        list(enumerate(server.backends)))
    except Exception:
        _log(server.tail())
        raise
    finally:
        server.stop()
    t_window_end = time.perf_counter()

    # Which backend served each request: the one whose wrapper saw it.
    backend_of = {int(i): b for b, rep in enumerate(reports) for i in rep["handed"]}
    served = {k: v for rep in reports for k, v in rep["served"].items()}
    phonemes = {k: v for rep in reports for k, v in rep["phonemes"].items()}
    metrics_e2e = end_to_end(results, mix["cap_s"], args.seconds, t0, mix["loop"])
    failed = sum(1 for r in results if r["error"] or r["first"] is None)
    stats = [rep["engine_stats"] for rep in reports]
    _log(f"requests {len(results)}, failed {failed}; generator lateness max {max(late, default=0) * 1e3:.1f} ms, "
         f"median {statistics.median(late) * 1e3 if late else 0:.1f} ms; engine {stats[0] if n_backends == 1 else stats}")
    if n_backends > 1:
        _log(f"memory peak per backend {[rep['memory_peak_bytes'] for rep in reports]}")
    for r in results:
        if r["error"]:
            _log(f"request {r['id']} failed: {r['error']}")
    print(json.dumps({"requests": [{"id": r["id"], "due": round(r["due"] - t0, 4),
                                    "ttfa_ms": None if r["first"] is None else round((r["first"] - r["due"]) * 1e3, 2),
                                    "audio_s": round(len(r["pcm"]) / 2 / r["sr"], 4),
                                    "stream_s": None if r["first"] is None else round(r["last"] - r["first"], 4),
                                    **({"backend": backend_of.get(r["id"])} if n_backends > 1 else {})}
                                   for r in results]}), flush=True)

    # Correctness, with the cards free: the reference on the greedy requests
    # (or the cell's sample of them), on the first card.
    from benchmark import check

    sample = check_sample(served, backend_of, args.seed)
    t_check = time.perf_counter()
    readings = check.run(doc, args.seed, device, {k: served[k] for k in sample}, phonemes, by_id,
                         {i: reqs[i].text for i in reqs}, {i: reqs[i].voice for i in reqs},
                         control=bool(args.control))
    _log(f"checked {readings['requests']} of {len(served)} served greedy requests in "
         f"{time.perf_counter() - t_check:.1f} s")
    other_weights = sum(rep["weight_checksum"] != readings["weight_checksum"] for rep in reports)
    limits = cell["limits"]
    checks = {
        "token_gap": {"value": readings["token_gap"], "limit": limits["token_gap"]},
        "pcm_err": {"value": readings["pcm_err"], "limit": limits["pcm_err"]},
        "unmatched_frames": {"value": readings["unmatched"], "limit": 0},
        "backends_with_other_weights": {"value": other_weights, "limit": 0},
        "checked_requests": {"value": readings["requests"], "limit": 1},
    }
    correct = judge(readings["token_gap"], readings["pcm_err"], readings["unmatched"], other_weights,
                    readings["requests"], limits)
    if args.control:
        # The control in the program's place, judged by the same expression.
        control_correct = judge(readings["control_token_gap"], readings["control_pcm_err"], readings["unmatched"],
                                other_weights, readings["requests"], limits)
        print(json.dumps({"control": readings, "control_correct": control_correct}), flush=True)
        _log(f"control token_gap {readings['control_token_gap']} pcm_err {readings['control_pcm_err']}: "
             f"correct {control_correct}")

    names = {m["name"] for m in spec.end_to_end(bench, args.workload)}
    units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": reports[0]["device"],
                   "count": w["chips"], "memory_peak_bytes": max(rep["memory_peak_bytes"] for rep in reports)}
    out = {"correct": bool(correct), "attempted": len(results), "failed": failed}
    if args.trace:
        # The requests' host times up to the slice: their first bytes came
        # before the profiler was asked for.
        opened = prof.get("asked", float("inf"))
        hosts = [{"id": r["id"], "backend": backend_of.get(r["id"]), "first": r["first"],
                  "handed": next((rep["handed"][str(r["id"])] for rep in reports if str(r["id"]) in rep["handed"]),
                                 None)} for r in results if r["first"] is not None and r["first"] < opened]
        metrics, breakdown = per_layer(bench, args.workload, names, doc, cell, trace_path, device_info, hosts,
                                       n_backends)
        out["metrics"] = metrics
        if breakdown:
            out["breakdown"] = breakdown
    else:
        values = dict(metrics_e2e, setup_s=setup_s)
        out["metrics"] = {k: {"value": values[k], "unit": units[k]} for k in sorted(names) if k in values}
    out["device"] = device_info
    out["setup_built_libraries"] = len(built)
    _log(f"window {args.seconds} s, drained in {t_window_end - t0 - args.seconds:.1f} s more; "
         f"end-to-end {json.dumps(metrics_e2e)}")

    bad = sorted(set(isolation.forbidden_modules()).union(*(rep["forbidden_modules"] for rep in reports)))
    if bad:
        _log(f"forbidden modules loaded: {bad}")
        return 3
    for k, v in checks.items():
        _log(f"check {k} {v['value']} limit {v['limit']}")
    out["checks"] = checks
    print(json.dumps(out), flush=True)
    return 0


def per_layer(bench, workload_name, names, doc, cell, trace_path, device_info, hosts, backends):
    """The per-layer metrics of this cell from the traced slice (a fleet's
    first backend's) and the requests' host times (``hosts``), its busy and
    window seconds, and the breakdown."""
    if not os.path.exists(trace_path):
        return {}, None
    with open(trace_path) as f:
        trace = json.load(f)
    if "error" in trace:
        _log(f"trace: {trace['error']}")
        return {}, None
    ctx = Context(trace, doc["config"], cell["rows"], hosts, backends)
    metrics = {}
    for m in spec.per_layer(bench, workload_name, sorted(names)):
        value = spec.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info["busy_s"] = ctx.busy_s()
    device_info["window_s"] = ctx.window_s
    ops: dict = {}
    for name, s, e in ctx.clipped():
        ops[name] = ops.get(name, 0.0) + (e - s) / 1e6
    gaps: dict = {}
    for sec, name in ctx.idle_gaps():
        gaps[name] = gaps.get(name, 0.0) + sec
    top = lambda d: [[k[:160], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return metrics, {"device_ops": top(ops), "idle_gaps": top(gaps)}


if __name__ == "__main__":
    sys.exit(main())
