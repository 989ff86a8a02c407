"""LayerNorm and RMSNorm with the math in float32 (port of ``zonos_tpu/ops/norms.py``)."""

from __future__ import annotations

import torch


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor | None, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis; math in f32, output in x.dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) / torch.sqrt(var + eps)
    y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last axis; math in f32, output in x.dtype."""
    xf = x.float()
    y = xf / torch.sqrt(xf.square().mean(dim=-1, keepdim=True) + eps) * scale.float()
    return y.to(x.dtype)
