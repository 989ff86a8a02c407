"""The port's native checkpoint: the params tree as it is, and config.json.

``params.pt`` is ``torch.save`` of the tree (dicts, lists, tensors and None,
which ``torch.load(weights_only=True)`` accepts), so quantized leaves and the
padded int8 heads come back in their layout without a conversion. It is not
the JAX package's native format (an orbax directory), and neither reads the
other's; the two packages exchange weights through the reference layout
(``utils.export.save_reference_checkpoint`` and ``Zonos.from_local``).
"""

from __future__ import annotations

import json
import os

import torch

from zonos_tpu_torch.config import ZonosConfig, config_to_dict


def save_checkpoint(path: str, params: dict, config: ZonosConfig | None = None) -> None:
    """Write ``path/params.pt`` and, with a config, ``path/config.json``."""
    os.makedirs(path, exist_ok=True)
    torch.save(params, os.path.join(path, "params.pt"))
    if config is not None:
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(config_to_dict(config), f, indent=2)


def load_checkpoint(path: str, device="cpu") -> dict:
    """The params tree saved by ``save_checkpoint``, on ``device``."""
    return torch.load(os.path.join(path, "params.pt"), map_location=device, weights_only=True)
