"""The port's counterpart of the persistent XLA compilation cache (port of
``zonos_tpu/utils/compile_cache.py``).

JAX keeps compiled executables on disk so a later process skips the
compile. The port compiles nothing at run time but its CUDA kernels, which
``ops/_build`` builds once into ``zonos_tpu_torch/build/`` (file names carry
a hash of the sources, so a later process reuses them). ``enable`` builds
the kernels not built yet, one ``nvcc`` each in parallel, before the first
request needs them, and returns the build directory. On the CPU (no card)
it builds nothing: the wrappers run their plain versions there.
"""

from __future__ import annotations


def enable(device=None) -> str:
    """Build every kernel library not built yet when ``device`` is a CUDA
    device (default: the card if there is one). Returns the build directory."""
    import torch

    from zonos_tpu_torch.ops import _build

    device = torch.device(device) if device is not None else torch.device(
        "cuda" if torch.cuda.is_available() else "cpu")
    if device.type == "cuda":
        _build.build_all()
    return str(_build.BUILD_DIR)
