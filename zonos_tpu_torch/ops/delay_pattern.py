"""Delay pattern over the 9 DAC codebooks (port of ``zonos_tpu/ops/delay_pattern.py``).

Codebook ``k`` is delayed by ``k + 1`` positions so the model can emit one
token per codebook per step while respecting the RVQ coarse-to-fine order.
The tensor variants run on the device; the ``_np`` variants are host-side.
"""

from __future__ import annotations

import numpy as np
import torch


def apply_delay_pattern(codes: torch.Tensor, mask_token: int) -> torch.Tensor:
    """[B, n_q, S] → [B, n_q, S + n_q]: pad by n_q, roll codebook k right by k+1."""
    n_q = codes.shape[1]
    padded = torch.nn.functional.pad(codes, (0, n_q), value=mask_token)
    return torch.stack([torch.roll(padded[:, k], k + 1, dims=-1) for k in range(n_q)], dim=1)


def apply_delay_pattern_np(codes: np.ndarray, mask_token: int) -> np.ndarray:
    n_q = codes.shape[1]
    padded = np.pad(codes, ((0, 0), (0, 0), (0, n_q)), constant_values=mask_token)
    return np.stack([np.roll(padded[:, k], k + 1, axis=-1) for k in range(n_q)], axis=1)


def revert_delay_pattern(codes: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`apply_delay_pattern`: [B, n_q, S] → [B, n_q, S - n_q]."""
    n_q, s = codes.shape[1], codes.shape[2]
    return torch.stack([codes[:, k, k + 1: s - n_q + k + 1] for k in range(n_q)], dim=1)


def revert_delay_pattern_np(codes: np.ndarray) -> np.ndarray:
    n_q, s = codes.shape[1], codes.shape[2]
    return np.stack([codes[:, k, k + 1: s - n_q + k + 1] for k in range(n_q)], axis=1)
