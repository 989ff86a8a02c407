"""The readers of the program's own spans (``benchmark.programspans``) on
synthetic spans and traces, and a CPU rehearsal of each cell with
``--trace 1`` in which every new metric that needs no device kernel reads a
value."""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from benchmark import programspans, spec
from benchmark.tests.conftest import REPO
from benchmark.tests.test_rehearsal import HERE, TINY
from benchmark.tracedata import Context

ENGINE, SOLO, FLEET = "tfm-int8.npc-stream.engine", "tfm-int8.npc-generate.solo", "tfm-int8.npc-stream.fleet4"


def ev(name, ts, dur, tid=1, **args):
    return {"name": name, "ph": "X", "ts": float(ts), "dur": float(dur), "pid": 1, "tid": tid, "args": args}


def steps(start, n, rng, tid=1):
    """``n`` decode steps one after another from ``start`` (µs), of uneven lengths."""
    out, t = [], start
    for _ in range(n):
        d = float(rng.uniform(40_000, 50_000))
        out.append(ev("decode.step", t, d - 30.0, tid))
        t += d
    return out


def test_a_planted_clock_offset_is_recovered():
    rng = np.random.default_rng(0)
    program = steps(1_000_000.0, 400, rng)
    planted = -7_654_321.25
    # The wrapper marks each step a few µs after the program opens its span.
    marks = [e["ts"] + planted + rng.uniform(2.0, 6.0) for e in program[250:320]]
    got = programspans.clock_offset([e["ts"] for e in program], marks)
    assert abs(got - planted) < 10.0


def test_warmup_and_profiled_spans_are_left_out():
    rng = np.random.default_rng(1)
    warm = steps(0.0, 10, rng, tid=2)  # the warm-up's request loop
    window = steps(warm[-1]["ts"] + 100_000, 60, rng)
    events = warm + [ev("server.warmup", 0.0, warm[-1]["ts"] + warm[-1]["dur"] + 10.0, tid=2)] + window
    events.append(ev("engine.dispatch", window[0]["ts"], 1.0))
    offset = 1e9
    t0 = window[40]["ts"] + offset  # the slice opens at step 40 ...
    t1 = window[-1]["ts"] + window[-1]["dur"] + offset
    marks = [e["ts"] + offset + 3.0 for e in window[40:]]  # ... where the wrapper's marks begin
    s = programspans.ProgramSpans(events, t0, t1, marks)
    assert abs(s.offset - (offset + 3.0)) < 1e-6
    kept = s.before_slice("decode.step")
    assert kept == window[:40]  # neither the warm-up's steps nor those in the slice
    assert s.mean_ms("decode.step", engine=True) == pytest.approx(np.mean([e["dur"] for e in window[:40]]) / 1e3)
    assert s.mean_ms("decode.step", engine=False) is None  # the warm-up's loop is out
    # The profiler's start-up slows the host before the slice opens: the
    # selection ends where the harness asked for it, ``profile_after_s`` after
    # the window opened with its first request.
    opened = window[0]["ts"] - 500.0
    events.append(ev("request", opened, 1e6, tid=5, endpoint="/stream"))
    cut = window[30]["ts"] - 10.0
    s = programspans.ProgramSpans(events, t0, t1, marks, profile_after_s=(cut - opened) / 1e6)
    assert s.before_slice("decode.step") == window[:29] + [e for e in window[29:30] if e["ts"] + e["dur"] <= cut]
    late = programspans.ProgramSpans(events, t0, t1, marks, profile_after_s=1e6)  # after the slice: the slice bounds
    assert late.before_slice("decode.step") == window[:40]


def _request(req, at, durs, tid):
    out, t = [], at
    for name, d in zip(programspans.STAGES, durs):
        out.append(ev(name, t, d, tid, req=req))
        t += d
    return out


def test_stage_means_sum_to_the_mean_program_ttfa():
    rng = np.random.default_rng(2)
    loop = steps(0.0, 200, rng, tid=9)
    events = loop + [ev("engine.dispatch", 0.0, 1.0, tid=9)]
    ttfa = []
    for r in range(12):
        durs = rng.uniform(100, 1e6, size=6)
        events += _request(r + 1, 1_000.0 + 400_000.0 * r, durs, tid=20 + r)
        ttfa.append(durs.sum())
    # A request whose first byte falls in the slice is left out, as one cut short.
    slice0 = 1_000.0 + 400_000.0 * 12 + 1.2e7
    events += _request(99, slice0 - 1e6, [5e5] * 6, tid=50)
    events += [ev("prep", 5e5, 10.0, tid=51, req=100)]
    s = programspans.ProgramSpans(events, slice0, slice0 + 3e6, [e["ts"] + 2.0 for e in loop[150:180]])
    assert abs(s.offset - 2.0) < 1e-6
    means = [s.stage_mean_ms(stage) for stage in programspans.STAGES]
    assert sum(means) == pytest.approx(np.mean(ttfa) / 1e3)
    assert s.stage_mean_ms("front.read", "front.write") == pytest.approx(means[0] + means[-1])
    assert len(s.requests()) == 12


def test_idle_in_step_share_on_a_synthetic_trace():
    from benchmark import spec as bspec

    # Slice [0, 1000] µs: kernels busy [100, 300] and [600, 700]; idle 0-100, 300-600, 700-1000 (700 µs).
    # Engine steps [50, 400] and [650, 900]: idle inside them 50 + 100 + 200 = 350 µs → 50%.
    names = ["k"]
    trace = {"names": names, "kernels": [[0, 100.0, 300.0], [0, 600.0, 700.0]], "ranges": [],
             "steps": [50.0, 650.0], "slice": [0.0, 1000.0]}
    ctx = Context(trace, {}, 32)
    offset = 5_000.0  # program clock = slice clock − offset
    events = [ev("decode.step", 50.0 - offset, 350.0, tid=3), ev("decode.step", 650.0 - offset, 250.0, tid=3),
              ev("engine.dispatch", 40.0 - offset, 900.0, tid=3),
              ev("decode.step", 320.0 - offset, 100.0, tid=4)]  # another thread's step: not the engine's
    ctx._program_spans = programspans.ProgramSpans(events, ctx.t0, ctx.t1, ctx.step_starts)
    assert bspec.reader("device_idle.in_step.engine")(ctx) == pytest.approx(50.0, abs=0.01)
    # The other thread's step covers idle 320-420 of 700.
    assert bspec.reader("device_idle.in_step.solo")(ctx) == pytest.approx(100 * 100 / 700, abs=0.01)


def test_readers_find_nothing_without_spans(tmpdir_env):
    trace = {"names": [], "kernels": [], "ranges": [], "steps": [10.0], "slice": [0.0, 100.0]}
    ctx = Context(trace, {}, 2)
    names = [m["name"] for m in spec.load()["per_layer"] if m["name"] not in (
        "engine.step_ms", "solo.frame_ms", "mfu_roofline.engine", "mfu_roofline.solo")]
    for name in names:
        assert spec.reader(name)(ctx) is None, name


NEW = {ENGINE: ["front.handler_ms", "prep.ms", "engine.join_wait_ms", "engine.first_audio_ms", "ship.lag_ms",
                "engine.step_host_ms", "engine.status_wait_ms"],
       SOLO: ["solo.step_host_ms"],
       FLEET: ["router.added_ms", "fleet.busiest_share"]}


@pytest.mark.parametrize("workload", [ENGINE, SOLO, FLEET])
def test_traced_rehearsal_reports_the_program_span_metrics(workload, tmp_path):
    """On the CPU the slice has no device kernel: the metrics that read one
    (``device_idle.in_step.*`` and the other device ones) stay out; each one
    read from the program's spans alone is there. The slice opens 6 s into a
    10 s window, after the first requests' first bytes."""
    w = spec.workload(spec.load(), workload)
    env = dict(os.environ, TMPDIR=str(tmp_path), OMP_NUM_THREADS="2")
    cmd = [sys.executable, "benchmark/run.py", "--workload", workload, "--seed", str(2**31 + 11), "--seconds", "10",
           "--trace", "1", "--platform", "cpu", "--config-file", os.path.join(HERE, TINY[w["config"]]),
           "--rate", "0.5"]
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["failed"] == 0
    for name in NEW[workload]:
        assert line["metrics"][name]["value"] > 0, name
    paths = glob.glob(os.path.join(tmp_path, "zonos-benchmark", "server", "output_temp", "*", "spans.json"))
    assert len(paths) == w["chips"]
    for path in paths:
        with open(path) as f:
            assert any(e["name"] == "server.warmup" for e in json.load(f)["traceEvents"])
