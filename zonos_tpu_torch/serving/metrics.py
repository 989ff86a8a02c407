"""Prometheus-style serving metrics (port of ``zonos_tpu/serving/metrics.py``).

Per-request RTF lines go to the log (serving/pipeline.py); this module adds
the aggregate surface at ``GET /metrics`` in the Prometheus text exposition
format. Pure stdlib, thread-safe, and process-local (one registry per server
process; a fleet behind serving/router.py is scraped per backend).

Exposed series:
  zonos_requests_total{endpoint,status}    request counter
  zonos_request_seconds{endpoint}          latency histogram (+ _sum/_count)
  zonos_audio_seconds_total                generated audio, wall seconds
  zonos_rtf                                per-request realtime-factor histogram
  zonos_batch_size                         coalesced batch-size histogram
"""

from __future__ import annotations

import threading
from bisect import bisect_left

# Histogram bucket upper bounds (seconds for latency; unitless for rtf/batch).
LATENCY_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)
RTF_BUCKETS = (0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0)
BATCH_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0)


class _Histogram:
    """Fixed-bucket cumulative histogram (Prometheus semantics)."""

    def __init__(self, buckets: tuple[float, ...]):
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)  # +1 = +Inf bucket
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.counts[bisect_left(self.buckets, value)] += 1
        self.sum += value
        self.count += 1


class Registry:
    """Thread-safe metric store rendering the Prometheus text format."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[tuple[str, tuple[tuple[str, str], ...]], float] = {}
        self._histograms: dict[tuple[str, tuple[tuple[str, str], ...]], _Histogram] = {}
        self._hist_buckets: dict[str, tuple[float, ...]] = {}
        self._help: dict[str, str] = {}

    def counter_inc(self, name: str, labels: dict[str, str] | None = None,
                    value: float = 1.0, help: str = "") -> None:
        key = (name, tuple(sorted((labels or {}).items())))
        with self._lock:
            if help:
                self._help.setdefault(name, help)
            self._counters[key] = self._counters.get(key, 0.0) + value

    def histogram_observe(self, name: str, value: float,
                          labels: dict[str, str] | None = None,
                          buckets: tuple[float, ...] = LATENCY_BUCKETS,
                          help: str = "") -> None:
        key = (name, tuple(sorted((labels or {}).items())))
        with self._lock:
            if help:
                self._help.setdefault(name, help)
            self._hist_buckets.setdefault(name, buckets)
            h = self._histograms.get(key)
            if h is None:
                h = self._histograms[key] = _Histogram(self._hist_buckets[name])
            h.observe(value)

    @staticmethod
    def _fmt_labels(labels: tuple[tuple[str, str], ...], extra: str = "") -> str:
        parts = [f'{k}="{v}"' for k, v in labels]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def render(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        out: list[str] = []
        with self._lock:
            names_seen: set[str] = set()
            for (name, labels), val in sorted(self._counters.items()):
                if name not in names_seen:
                    names_seen.add(name)
                    if name in self._help:
                        out.append(f"# HELP {name} {self._help[name]}")
                    out.append(f"# TYPE {name} counter")
                out.append(f"{name}{self._fmt_labels(labels)} {val:g}")
            for (name, labels), h in sorted(self._histograms.items()):
                if name not in names_seen:
                    names_seen.add(name)
                    if name in self._help:
                        out.append(f"# HELP {name} {self._help[name]}")
                    out.append(f"# TYPE {name} histogram")
                cum = 0
                for ub, c in zip(h.buckets, h.counts):
                    cum += c
                    out.append(
                        f"{name}_bucket{self._fmt_labels(labels, f'le=\"{ub:g}\"')} {cum}"
                    )
                out.append(
                    f"{name}_bucket{self._fmt_labels(labels, 'le=\"+Inf\"')} {h.count}"
                )
                out.append(f"{name}_sum{self._fmt_labels(labels)} {h.sum:g}")
                out.append(f"{name}_count{self._fmt_labels(labels)} {h.count}")
        return "\n".join(out) + "\n"

    def reset(self) -> None:
        """Test hook: drop all series."""
        with self._lock:
            self._counters.clear()
            self._histograms.clear()
            self._hist_buckets.clear()
            self._help.clear()


REGISTRY = Registry()


def observe_request(endpoint: str, status: int, seconds: float) -> None:
    """Record one HTTP request (called from the server request paths)."""
    REGISTRY.counter_inc(
        "zonos_requests_total",
        {"endpoint": endpoint, "status": str(status)},
        help="HTTP requests served, by endpoint and status code",
    )
    REGISTRY.histogram_observe(
        "zonos_request_seconds", seconds, {"endpoint": endpoint},
        buckets=LATENCY_BUCKETS,
        help="Wall-clock request latency in seconds",
    )


def observe_generation(rtf: float, audio_seconds: float,
                       batch_size: int | None = None) -> None:
    """Record one finished generation (single or batched-member)."""
    REGISTRY.counter_inc(
        "zonos_audio_seconds_total", value=audio_seconds,
        help="Total seconds of audio generated",
    )
    REGISTRY.histogram_observe(
        "zonos_rtf", rtf, buckets=RTF_BUCKETS,
        help="Per-request realtime factor (audio seconds / wall seconds)",
    )
    if batch_size is not None:
        observe_batch(batch_size)


def observe_batch(size: int) -> None:
    """Record one coalesced decode batch (called from the DynamicBatcher)."""
    REGISTRY.histogram_observe(
        "zonos_batch_size", float(size), buckets=BATCH_BUCKETS,
        help="Coalesced decode batch size",
    )
