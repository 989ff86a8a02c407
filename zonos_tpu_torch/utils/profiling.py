"""Tracing and profiling helpers (port of ``zonos_tpu/utils/profiling.py``).

``device_timer`` times a span on the host clock after waiting for the card's
queued work (``torch.cuda.synchronize``), ``torch_trace`` writes a
``torch.profiler`` Chrome trace, ``memory_report`` and
``device_memory_table`` read ``torch.cuda``'s allocator statistics, and
``log_rtf`` logs a request's real-time factor. XLA's per-executable memory
analysis has no counterpart: nothing is compiled ahead of a call here.

The span recorder (``SpanRecorder``; the process's own is ``RECORDER``, used
through ``span``, ``traced``, ``record`` and ``attach``) keeps what the
program does on the host clock (``time.perf_counter_ns``): a span's name, id,
parent (the span open on the same thread), request id, thread, start, end
and counters as ``args``. Spans go into a bounded ring: the oldest drop, and
the recorder counts them. It records unless ``ZONOS_TRACE=0`` is set (the
server also reads the key from ``configmodel.txt``); off, ``span`` returns
one shared no-op and ``record`` returns at once. ``chrome_trace`` renders
the ring as Chrome trace-event JSON (chrome://tracing, Perfetto).
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import json
import logging
import os
import threading
import time

import torch

logger = logging.getLogger("zonos_tpu_torch")

MB = 1024**2

RING_SPANS = 2**17


class _NoSpan:
    """What ``span`` returns while the recorder is off."""

    __slots__ = ()
    id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("rec", "name", "id", "parent", "req", "args", "start")

    def __init__(self, rec, name, req, args):
        self.rec, self.name, self.req, self.args = rec, name, req, args
        self.id = next(rec._ids)

    def __enter__(self):
        local = self.rec._local
        stack = local.__dict__.setdefault("stack", [])
        self.parent = stack[-1] if stack else None
        if self.req is None:
            self.req = getattr(local, "req", None)
        stack.append(self.id)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.rec._local.stack.pop()
        self.rec._append((self.name, self.id, self.parent, self.req, threading.get_ident(), self.start, end,
                          self.args or None))
        return False


class SpanRecorder:
    """A bounded ring of host spans (see the module's docstring)."""

    def __init__(self, capacity: int = RING_SPANS, enabled: bool = True):
        self.enabled = enabled
        self.dropped = 0
        self._ring = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._local = threading.local()

    def span(self, name: str, req: int | None = None, **args):
        """Context manager recording the ``with`` block as one span, under
        the span open on the thread. ``req`` defaults to the request the
        thread is attached to."""
        if not self.enabled:
            return _NO_SPAN
        return _Span(self, name, req, args)

    def record(self, name: str, start_ns: int, end_ns: int, req: int | None = None, **args) -> None:
        """A span whose ends were taken earlier or on other threads, under
        the span open on this thread."""
        if not self.enabled:
            return
        stack = getattr(self._local, "stack", None)
        self._append((name, next(self._ids), stack[-1] if stack else None,
                      getattr(self._local, "req", None) if req is None else req,
                      threading.get_ident(), start_ns, end_ns, args or None))

    @contextlib.contextmanager
    def attach(self, req: int | None):
        """Spans opened on this thread inside the block carry request ``req``."""
        saved = getattr(self._local, "req", None)
        self._local.req = req
        try:
            yield
        finally:
            self._local.req = saved

    def _append(self, item: tuple) -> None:
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(item)

    def spans(self) -> list[tuple]:
        """(name, id, parent, req, thread, start ns, end ns, args) of every span in the ring, oldest first."""
        with self._lock:
            return list(self._ring)

    def chrome_trace(self) -> dict:
        """The ring as Chrome trace-event JSON: complete events (``ph`` "X")
        with ``ts`` and ``dur`` in µs on the ``perf_counter_ns`` clock, and
        ``id``, ``parent`` and ``req`` among their ``args``."""
        with self._lock:
            spans, dropped = list(self._ring), self.dropped
        pid = os.getpid()
        events = [{"name": name, "ph": "X", "ts": s / 1e3, "dur": (e - s) / 1e3, "pid": pid, "tid": tid,
                   "args": dict(args or {}, id=sid, parent=parent, req=req)}
                  for name, sid, parent, req, tid, s, e, args in spans]
        return {"traceEvents": events, "displayTimeUnit": "ms", "clock": "perf_counter_ns", "dropped": dropped}

    def write_chrome_trace(self, path: str) -> str:
        """``chrome_trace()`` written to ``path`` whole (a temporary file renamed into place)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(self.chrome_trace(), f)
        os.replace(tmp, path)
        return path


def _off(value) -> bool:
    return str(value).strip().lower() in {"0", "false", "no", "off"}


RECORDER = SpanRecorder(enabled=not _off(os.environ.get("ZONOS_TRACE", "1")))
span = RECORDER.span
record = RECORDER.record
attach = RECORDER.attach


def traced(name: str):
    """Decorator: each call of the function is one span ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with RECORDER.span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def configure_tracing(app_config: dict | None = None) -> bool:
    """Turn ``RECORDER`` off where ``ZONOS_TRACE=0`` is set in the
    environment or in the app config (``configmodel.txt``); returns whether it records."""
    RECORDER.enabled = not (_off(os.environ.get("ZONOS_TRACE", "1"))
                            or _off((app_config or {}).get("ZONOS_TRACE", "1")))
    return RECORDER.enabled


def _tensors(value):
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, dict):
        for v in value.values():
            yield from _tensors(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _tensors(v)


def _wait(value) -> None:
    """Wait for the queued work of every CUDA device a tensor of ``value`` lives on."""
    for dev in {t.device for t in _tensors(value) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def device_timer(name: str, result: object = None):
    """Time device work honestly: the span ends after the card has finished it.

    Usage:
        with device_timer("decode") as t:
            out = fn(...)
            t.wait_for(out)
        print(t.elapsed_s)

    ``wait_for`` synchronizes the CUDA devices its value's tensors live on
    (nothing on the CPU, where work is done when a call returns).
    """

    class _T:
        elapsed_s = 0.0

        def wait_for(self, value):
            _wait(value)

    t = _T()
    t0 = time.perf_counter()
    try:
        yield t
    finally:
        t.elapsed_s = time.perf_counter() - t0
        logger.debug(f"{name}: {t.elapsed_s * 1e3:.1f} ms")


@contextlib.contextmanager
def torch_trace(log_dir: str = "profile_logs"):
    """Profile the span (CPU ops, and CUDA kernels where there is a card) and
    write a Chrome trace (chrome://tracing, Perfetto) into ``log_dir``.
    Yields the ``torch.profiler.profile``; its ``trace_path`` is set on exit."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.trace_path = os.path.join(log_dir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json")
    prof.export_chrome_trace(prof.trace_path)
    logger.info(f"profiler trace written to {prof.trace_path}")


def _bytes(value) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(value))


def memory_report(fn, *args, **kwargs) -> str:
    """Run ``fn(*args, **kwargs)`` once and report its memory as a text table:
    the argument and output tensors' bytes and, on the card, the peak the
    allocator reached above what was allocated before the call."""
    cuda = [t.device for t in _tensors((args, kwargs)) if t.device.type == "cuda"]
    dev = cuda[0] if cuda else None
    if dev is not None:
        torch.cuda.synchronize(dev)
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    out = fn(*args, **kwargs)
    rows = [("arguments", _bytes((args, kwargs))), ("outputs", _bytes(out))]
    if dev is not None:
        _wait(out)
        rows.append(("temps (peak scratch)", torch.cuda.max_memory_allocated(dev) - before - rows[1][1]))
    lines = ["allocation            |       MB", "-" * 34]
    lines += [f"{name:21} | {v / MB:8.2f}" for name, v in rows]
    lines.append("-" * 34)
    lines.append(f"{'total live (args+out+temp)':21} | {sum(max(v, 0) for _, v in rows) / MB:8.2f}")
    if dev is None:
        lines.append("(temps not measured: no CUDA tensor among the arguments)")
    return "\n".join(lines)


def device_memory_table() -> str:
    """Per-card memory: in use, peak and reserved by the allocator, and the card's total."""
    if not torch.cuda.is_available():
        return "no CUDA devices"
    lines = []
    for i in range(torch.cuda.device_count()):
        line = (f"{'cuda:' + str(i) + ' ' + torch.cuda.get_device_name(i):24} | "
                f"in use {torch.cuda.memory_allocated(i) / MB:9.1f} MB | "
                f"peak {torch.cuda.max_memory_allocated(i) / MB:9.1f} MB | "
                f"reserved {torch.cuda.memory_reserved(i) / MB:9.1f} MB | "
                f"limit {torch.cuda.get_device_properties(i).total_memory / MB:9.1f} MB")
        lines.append(line)
    return "\n".join(lines)


def log_rtf(audio_seconds: float, wall_seconds: float, context: str = "") -> float:
    """Per-request RTF log line."""
    rtf = audio_seconds / wall_seconds if wall_seconds > 0 else 0.0
    logger.info(f"RTF{' ' + context if context else ''}: {audio_seconds:.2f}s audio / "
                f"{wall_seconds:.2f}s wall = {rtf:.2f}x realtime")
    return rtf
