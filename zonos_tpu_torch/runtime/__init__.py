"""Generation runtime: prefill, decode loop, code post-processing."""
