"""Backbone dispatch (port of ``zonos_tpu/models/backbone.py``): the
transformer, or the hybrid (Mamba2 + attention) when the config has an
``ssm_cfg``."""

from __future__ import annotations

import torch

from zonos_tpu_torch.config import BackboneConfig
from zonos_tpu_torch.models.hybrid import HybridCache, hybrid_forward, init_hybrid_params
from zonos_tpu_torch.models.transformer import KVCache, init_transformer_params, transformer_forward


def init_backbone_params(generator: torch.Generator, cfg: BackboneConfig, dtype=torch.bfloat16, device=None) -> dict:
    init = init_hybrid_params if cfg.is_hybrid else init_transformer_params
    return init(generator, cfg, dtype, device)


def create_cache(cfg: BackboneConfig, batch_size: int, max_seqlen: int, dtype=torch.bfloat16,
                 kv_int8: bool = False, device=None) -> KVCache | HybridCache:
    if cfg.is_hybrid:
        return HybridCache.create(cfg, batch_size, max_seqlen, dtype, kv_int8=kv_int8, device=device)
    return KVCache.create(cfg, batch_size, max_seqlen, dtype, quantized=kv_int8, device=device)


def backbone_forward(params, cfg: BackboneConfig, x, cache, write_start, pad_amount, attend_len,
                     pos_offset=None, gap_len=None, gap_start=0):
    """(x [B,S,D], cache) → (normed hidden [B,S,D], cache). S > 1 ⇒ prefill."""
    forward = hybrid_forward if cfg.is_hybrid else transformer_forward
    return forward(params, cfg, x, cache, write_start, pad_amount, attend_len,
                   pos_offset=pos_offset, gap_len=gap_len, gap_start=gap_start)
