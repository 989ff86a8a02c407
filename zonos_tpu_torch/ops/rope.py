"""Rotary position embeddings (port of ``zonos_tpu/ops/rope.py``).

``apply_rope``: the transformer's paired-dims convention, dimensions rotate as
consecutive (even, odd) pairs (x viewed as ``[..., head_dim // 2, 2]``).
``apply_rope_neox``: the hybrid's half-split convention.
"""

from __future__ import annotations

import torch


def rope_rows(positions: torch.Tensor, n_elem: int, base: float = 10000.0) -> torch.Tensor:
    """Cos/sin rows for integer positions [...] → [..., n_elem // 2, 2] (f32)."""
    exps = torch.arange(0, n_elem, 2, dtype=torch.float32, device=positions.device)[: n_elem // 2] / n_elem
    freqs = 1.0 / (base ** exps)
    angles = positions.float()[..., None] * freqs
    return torch.stack([torch.cos(angles), torch.sin(angles)], dim=-1)


def apply_rope(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """Rotate x [B, S, H, Dh] by freqs [S, Dh//2, 2] or [B, S, Dh//2, 2]; math in f32."""
    b, s, h, dh = x.shape
    xf = x.float().reshape(b, s, h, dh // 2, 2)
    if freqs.dim() == 3:
        fc = freqs[None, :, None, :, 0]
        fs = freqs[None, :, None, :, 1]
    else:
        fc = freqs[:, :, None, :, 0]
        fs = freqs[:, :, None, :, 1]
    x0, x1 = xf[..., 0], xf[..., 1]
    out = torch.stack([x0 * fc - x1 * fs, x1 * fc + x0 * fs], dim=-1)
    return out.reshape(b, s, h, dh).to(x.dtype)


def apply_rope_neox(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """Rotate x [B, S, H, r] (exactly the rotary span) in the half-split (NeoX)
    convention: (x[..., :r/2], x[..., r/2:]) rotate as pairs. The hybrid
    backbone's attention layers rotate this way (mamba-ssm's MHA); freqs is
    [S, r//2, 2] or [B, S, r//2, 2]; math in f32."""
    r = x.shape[-1]
    xf = x.float()
    x1, x2 = xf[..., : r // 2], xf[..., r // 2:]
    if freqs.dim() == 3:
        fc, fs = freqs[None, :, None, :, 0], freqs[None, :, None, :, 1]
    else:
        fc, fs = freqs[:, :, None, :, 0], freqs[:, :, None, :, 1]
    return torch.cat([x1 * fc - x2 * fs, x2 * fc + x1 * fs], dim=-1).to(x.dtype)
