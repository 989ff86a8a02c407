"""Backbone dispatch (port of ``zonos_tpu/models/backbone.py``).

Only the transformer backbone is ported; a hybrid (Mamba2 + attention)
config raises until the hybrid slice lands (ROADMAP.md).
"""

from __future__ import annotations

import torch

from zonos_tpu_torch.config import BackboneConfig
from zonos_tpu_torch.models.transformer import KVCache, init_transformer_params, transformer_forward

HYBRID_TODO = "the hybrid (Mamba2) backbone is not ported yet: see ROADMAP.md, 'Hybrid backbone'"


def init_backbone_params(generator: torch.Generator, cfg: BackboneConfig, dtype=torch.bfloat16, device=None) -> dict:
    if cfg.is_hybrid:
        raise NotImplementedError(HYBRID_TODO)
    return init_transformer_params(generator, cfg, dtype, device)


def create_cache(cfg: BackboneConfig, batch_size: int, max_seqlen: int, dtype=torch.bfloat16,
                 kv_int8: bool = False, device=None) -> KVCache:
    if cfg.is_hybrid:
        raise NotImplementedError(HYBRID_TODO)
    return KVCache.create(cfg, batch_size, max_seqlen, dtype, quantized=kv_int8, device=device)


def backbone_forward(params, cfg: BackboneConfig, x, cache, write_start, pad_amount, attend_len,
                     pos_offset=None, gap_len=None, gap_start=0):
    """(x [B,S,D], cache) → (normed hidden [B,S,D], cache). S > 1 ⇒ prefill."""
    if cfg.is_hybrid:
        raise NotImplementedError(HYBRID_TODO)
    return transformer_forward(
        params, cfg, x, cache, write_start, pad_amount, attend_len,
        pos_offset=pos_offset, gap_len=gap_len, gap_start=gap_start,
    )
