"""The knee sweep of an open-loop cell: the highest arrival rate that the
server sustains without a growing backlog.

    python3 benchmark/knee.py --workload <name> --seed <n> --seconds <s> --rates 0.6,0.8,1.0

The cell's server, or its fleet of servers behind the router (as ``run.py``
starts them), serves the cell's mix at each rate in
turn for ``--seconds`` seconds, every request followed to its end before the
next rate starts. For each rate it prints one JSON line: the requests, the
failures, the TTFA's median and 90th percentile, and the backlog's growth,
the slope of each request's wait for its first byte against its due time
(ms of wait per s of window; near 0 while the server keeps up). The knee is
the highest rate whose slope stays under ``--slope`` ms/s with no failure.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
sys.path.insert(0, REPO)

from benchmark import client, spec, traffic  # noqa: E402
from benchmark.run import START_TIMEOUT_S, Fleet, p90  # noqa: E402


def slope_ms_per_s(xs: list, ys: list) -> float:
    mx, my = statistics.fmean(xs), statistics.fmean(ys)
    var = sum((x - mx) ** 2 for x in xs)
    return sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / var if var else 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--slope", type=float, default=50.0)
    args = ap.parse_args(argv)
    bench = spec.load()
    w = spec.workload(bench, args.workload)
    cell, mix = spec.cell(args.workload), spec.traffic(w["traffic"])
    cfg_path = spec.config_path(bench, w["config"])
    with open(cfg_path) as f:
        doc = json.load(f)
    work_root = os.path.join(os.environ.get("TMPDIR") or os.path.join(REPO, "benchmark_out"), "zonos-knee")
    shutil.rmtree(work_root, ignore_errors=True)
    os.makedirs(work_root)
    server = Fleet(cfg_path, args.seed, os.path.join(work_root, "server"), cell, doc["model_choice"], False, "cuda",
                   "", work_root, w["chips"])
    knee = None
    try:
        server.wait_ready(START_TIMEOUT_S)
        print(json.dumps({"setup_s": time.perf_counter() - T_START}), flush=True)
        for i, rate in enumerate(float(r) for r in args.rates.split(",")):
            reqs = traffic.make_requests(mix, args.seed + i, args.seconds, rate)
            bodies = [r.body(mix, doc["model_choice"]) for r in reqs]
            t0 = time.perf_counter()
            res = client.open_loop(server.port, reqs, bodies, t0, mix["cap_s"])
            ok = [r for r in res if not r["error"] and r["first"] is not None]
            waits = [(r["first"] - r["due"]) * 1e3 for r in ok]
            audio = sum(len(r["pcm"]) / 2 / r["sr"] for r in ok)
            slope = slope_ms_per_s([r["due"] - t0 for r in ok], waits) if len(ok) > 2 else float("inf")
            line = {"rate_rps": rate, "requests": len(res), "failed": len(res) - len(ok),
                    "ttfa_p50_ms": statistics.median(waits) if waits else None,
                    "ttfa_p90_ms": p90(waits) if waits else None,
                    "offered_audio_s_per_s": audio / args.seconds, "backlog_slope_ms_per_s": slope,
                    "drain_s": time.perf_counter() - t0 - args.seconds}
            print(json.dumps(line), flush=True)
            if line["failed"] == 0 and slope < args.slope:
                knee = rate
    finally:
        server.stop()
    print(json.dumps({"knee_rps": knee, "at_0.8": None if knee is None else round(0.8 * knee, 3)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
