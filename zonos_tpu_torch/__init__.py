"""PyTorch/CUDA port of Zonos-TPU.

A second package beside the JAX one: the same model, params layout and
runtime, in PyTorch, with the TPU's Pallas kernels rewritten by hand in CUDA
for Hopper (``csrc/``). It imports ``torch`` and ``numpy`` only.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks otherwise.

    ``device=None`` means CUDA, and raises where there is no card rather than
    falling back to the CPU; callers that want the CPU say so.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "zonos_tpu_torch runs on a CUDA device by default and none is available; "
                "pass device='cpu' explicitly to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
