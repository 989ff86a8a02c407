"""What the per-layer readers read: the traced slice of a ``--trace 1`` run.

The server wrapper writes the slice as JSON: kernel names, each device
kernel's interval (µs on the profiler's clock), the wrapper's host ranges and
the host times at which the decode steps started, on the same clock, and the
slice's bounds.
``Context`` adds what the cell says (the configuration and the rows a decode
step runs), the requests' host times (``requests``: of each request whose
first byte came before the profiler was asked for, its id, the backend that
served it, the client's first byte and the moment the serving backend's
wrapper handed its first chunk to the HTTP layer, on the host's monotonic
clock) and the number of backends, and the derived counts every reader
shares. A fleet traces its first backend alone.
"""

from __future__ import annotations

from benchmark import roofline


class Context:
    def __init__(self, trace: dict, cfg: dict, rows: int, requests: list | None = None, backends: int = 1):
        self.cfg, self.rows = cfg, rows
        self.requests, self.backends = requests or [], backends
        names = trace["names"]
        self.kernels = [(names[i], s, e) for i, s, e in trace["kernels"]]
        self.t0, self.t1 = trace["slice"]
        self.ranges = trace["ranges"]
        self.step_starts = trace.get("steps", [])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def clipped(self):
        """Kernel intervals clipped to the slice."""
        for name, s, e in self.kernels:
            s, e = max(s, self.t0), min(e, self.t1)
            if e > s:
                yield name, s, e

    def busy_s(self) -> float:
        """Time with at least one kernel running: the union of the intervals."""
        busy, end = 0.0, float("-inf")
        for _, s, e in sorted(self.clipped(), key=lambda k: k[1]):
            if e > end:
                busy += e - max(s, end)
                end = e
        return busy / 1e6

    def steps(self) -> int | None:
        """Decode steps that started in the slice, as the wrapper marked them
        on the host (one per call of the backbone's one-frame forward)."""
        return len(self.step_starts) or None

    def kernel_time_s(self, families=roofline.K1_K3) -> tuple[float, int]:
        """(Σ device seconds, launches) of the kernels whose names hold one of ``families``."""
        t, n = 0.0, 0
        for name, s, e in self.kernels:
            if any(f in name for f in families):
                t += e - s
                n += 1
        return t / 1e6, n

    def idle_gaps(self):
        """(gap seconds, the host range open at its start) for every gap
        between kernels in the slice; the range is the latest-started one
        open on any thread, or ``host:none``."""
        spans = sorted((s, e) for _, s, e in self.clipped())
        end = self.t0
        out = []
        for s, e in spans + [(self.t1, self.t1)]:
            if s > end:
                open_ = [r for r in self.ranges if r[2] <= end < r[3]]
                name = max(open_, key=lambda r: r[2])[0] if open_ else "host:none"
                out.append(((s - end) / 1e6, name))
            end = max(end, e)
        return out
