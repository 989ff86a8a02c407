"""Tracing and profiling helpers (port of ``zonos_tpu/utils/profiling.py``).

``device_timer`` times a span on the host clock after waiting for the card's
queued work (``torch.cuda.synchronize``), ``torch_trace`` writes a
``torch.profiler`` Chrome trace, ``memory_report`` and
``device_memory_table`` read ``torch.cuda``'s allocator statistics, and
``log_rtf`` logs a request's real-time factor. XLA's per-executable memory
analysis has no counterpart: nothing is compiled ahead of a call here.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import torch

logger = logging.getLogger("zonos_tpu_torch")

MB = 1024**2


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
