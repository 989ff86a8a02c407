"""How evenly the router spread the requests over the backends, of those
whose first byte came before the traced slice: the requests the busiest
backend served over the mean per backend (1.0 is an even split,
``backends`` the most)."""

from collections import Counter


def read(ctx):
    counts = Counter(r["backend"] for r in ctx.requests if r["backend"] is not None)
    return max(counts.values()) * ctx.backends / sum(counts.values()) if counts else None
