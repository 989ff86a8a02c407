"""The program's own spans, for the per-layer readers that read them.

The server's span recorder (``zonos_tpu_torch.utils.profiling``) writes its
ring, Chrome trace-event JSON on the ``perf_counter_ns`` clock (µs), to
``spans.json`` in the server's output directory when the server stops; the
harness stops it (SIGTERM) before it reads the per-layer metrics, so the
file is there: ``($TMPDIR or <repo>/benchmark_out)/zonos-benchmark/server/
output_temp/*/spans.json``, as ``run.py`` lays the run out. A program that
writes no such file gives every reader here nothing (``None``).

The program's clock is mapped onto the traced slice's by the decode steps
both sides record: the wrapper marks each call of the backbone's one-frame
forward (``tracedata.Context.step_starts``), the program opens a
``decode.step`` span just before it. The offset is the median difference
between each mark and the nearest ``decode.step`` start, once the marks have
been lined up with the steps they belong to.

Two selections: the spans after the server's warm-up (``server.warmup``)
that ended before the harness asked for the profiler, the part of the window
the profiler does not slow, for the means; and the ``decode.step`` spans
inside the slice, for the share of the device's idle time that falls inside
a step. The profiler's start-up already slows the server's host, for seconds
under load (13.8 s, with steps of 0.3-1.3 s, in an engine run on the H100),
so the first selection ends where ``run.py`` asks for the profiler: its
window opens with the first request (the earliest ``request`` span after the
warm-up) and the request comes ``--seconds`` − the slice − 1 s later, or at
the slice's start if that is earlier.
"""

from __future__ import annotations

import glob
import json
import os
import sys

import numpy as np

from benchmark import spec

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

# A /stream request's wait for first audio, in the program's six stages (the
# order of ``zonos_tpu_torch.serving.batcher.STREAM_STAGES``).
STAGES = ("front.read", "prep", "engine.join_wait", "engine.first_audio", "ship", "front.write")


def spans_path() -> str | None:
    """The newest ``spans.json`` of this run's server, or None."""
    root = os.path.join(os.environ.get("TMPDIR") or os.path.join(REPO, "benchmark_out"), "zonos-benchmark", "server",
                        "output_temp")
    found = sorted(glob.glob(os.path.join(root, "*", "spans.json")), key=os.path.getmtime)
    return found[-1] if found else None


def clock_offset(starts, marks) -> float | None:
    """µs to add to the program's clock to land on the slice's: the median of
    (mark − nearest step start) once the marks are lined up with the steps.
    The line-up tries each start as the first mark's step and keeps the one
    whose marks sit closest to starts (the steps' lengths vary, so a line-up
    off by whole steps misses by their differences)."""
    starts = np.sort(np.asarray(starts, dtype=np.float64))
    marks = np.sort(np.asarray(marks, dtype=np.float64))
    if not len(starts) or not len(marks):
        return None

    def diffs(d: float) -> np.ndarray:
        shifted = marks - d
        i = np.searchsorted(starts, shifted)
        lo, hi = starts[np.clip(i - 1, 0, len(starts) - 1)], starts[np.clip(i, 0, len(starts) - 1)]
        return np.where(np.abs(shifted - lo) <= np.abs(shifted - hi), shifted - lo, shifted - hi)

    best = min((float(np.median(np.abs(diffs(marks[0] - s)))), marks[0] - s) for s in starts)[1]
    return float(best + np.median(diffs(best)))


def _union(intervals) -> list:
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap(a: list, b: list) -> float:
    """Σ length of the intersection of two sorted lists of disjoint intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


class ProgramSpans:
    """The spans of one run (``events``: Chrome events with ``ph`` "X"),
    against the traced slice ``[t0, t1]`` and the wrapper's step marks, both
    on the slice's clock; ``profile_after_s``: seconds from the window's
    opening to the harness's request for the profiler (None: the slice's
    start bounds the first selection alone)."""

    def __init__(self, events: list, t0: float, t1: float, step_marks: list, profile_after_s: float | None = None):
        self.events = [e for e in events if e.get("ph") == "X"]
        starts = [e["ts"] for e in self.events if e["name"] == "decode.step"]
        self.offset = clock_offset(starts, step_marks)
        warm = [e["ts"] + e["dur"] for e in self.events if e["name"] == "server.warmup"]
        self.after = max(warm) if warm else float("-inf")
        self.t0, self.t1 = t0, t1
        # Threads that run the continuous engine's loop.
        self.engine_tids = {e["tid"] for e in self.events if e["name"] == "engine.dispatch"}
        self.until = None
        if self.offset is not None:
            self.until = t0 - self.offset
            opened = [e["ts"] for e in self.events if e["name"] == "request" and e["ts"] >= self.after]
            if opened and profile_after_s is not None:
                self.until = min(self.until, min(opened) + max(profile_after_s, 0.0) * 1e6)

    def before_slice(self, name: str) -> list:
        """Spans ``name`` that began after the warm-up and ended before the
        harness asked for the profiler (``until``)."""
        if self.until is None:
            return []
        return [e for e in self.events
                if e["name"] == name and e["ts"] >= self.after and e["ts"] + e["dur"] <= self.until]

    def mean_ms(self, name: str, engine: bool | None = None) -> float | None:
        """Mean duration of ``name`` before the slice; ``engine`` keeps only
        the engine's threads (True) or only the others (False)."""
        spans = [e for e in self.before_slice(name)
                 if engine is None or (e["tid"] in self.engine_tids) == engine]
        return float(np.mean([e["dur"] for e in spans])) / 1e3 if spans else None

    def requests(self) -> dict:
        """req → {stage: duration µs} of every /stream request whose six stages
        all lie after the warm-up and before the slice."""
        by_req: dict = {}
        for name in STAGES:
            for e in self.before_slice(name):
                by_req.setdefault(e["args"].get("req"), {})[name] = e["dur"]
        return {r: d for r, d in by_req.items() if r is not None and len(d) == len(STAGES)}

    def stage_mean_ms(self, *stages: str) -> float | None:
        """Mean over the requests of the summed durations of ``stages``, in ms."""
        reqs = self.requests()
        if not reqs:
            return None
        return float(np.mean([sum(d[s] for s in stages) for d in reqs.values()])) / 1e3

    def idle_in_step_pct(self, kernels, engine: bool) -> float | None:
        """Share of the slice's device-idle time (no kernel running) that lies
        inside a ``decode.step`` span of the engine's threads (``engine``) or
        of the others, in %."""
        if self.offset is None or not kernels:
            return None
        busy = _union([(max(s, self.t0), min(e, self.t1)) for s, e in kernels if min(e, self.t1) > max(s, self.t0)])
        idle, at = [], self.t0
        for s, e in busy + [[self.t1, self.t1]]:
            if s > at:
                idle.append([at, s])
            at = max(at, e)
        steps = _union([(e["ts"] + self.offset, e["ts"] + e["dur"] + self.offset) for e in self.events
                        if e["name"] == "decode.step" and (e["tid"] in self.engine_tids) == engine])
        total = sum(e - s for s, e in idle)
        if not steps or total <= 0:
            return None
        return 100.0 * _overlap(idle, steps) / total


def run_seconds() -> float:
    """The window's length: ``--seconds`` of ``run.py``, in whose process the
    readers run, else ``BENCHMARK.json``'s ``run_seconds``."""
    if "--seconds" in sys.argv[:-1]:
        return float(sys.argv[sys.argv.index("--seconds") + 1])
    return float(spec.load()["run_seconds"])


def load(ctx) -> ProgramSpans | None:
    """This run's program spans against the traced slice of ``ctx``
    (``tracedata.Context``), read once per context; None where the program
    wrote none or no decode step lines the two clocks up."""
    if "_program_spans" not in vars(ctx):
        path = spans_path()
        spans = None
        if path is not None:
            try:
                with open(path) as f:
                    doc = json.load(f)
                # run.py asks for the profiler (slice + 1 s) before the window closes.
                spans = ProgramSpans(doc["traceEvents"], ctx.t0, ctx.t1, ctx.step_starts,
                                     profile_after_s=run_seconds() - ctx.window_s - 1.0)
            except (OSError, ValueError, KeyError) as e:
                print(f"program spans: {path}: {e!r}", file=sys.stderr, flush=True)
            if spans is not None and spans.offset is None:
                spans = None
        ctx._program_spans = spans
    return ctx._program_spans


def kernel_intervals(ctx) -> list:
    """(start, end) of every device kernel in the slice, on its clock."""
    return [(s, e) for _, s, e in ctx.kernels]
