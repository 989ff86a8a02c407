"""Model configuration dataclasses for the PyTorch/CUDA port.

The port's own copy of the parts of ``zonos_tpu/config.py`` and the
``DACConfig`` of ``zonos_tpu/codec/dac.py`` that its main path needs: same
field names, defaults and presets, so a configuration means the same model in
both packages. The port imports nothing of ``zonos_tpu``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    """Attention sub-config (``num_heads`` query heads, ``num_heads_kv`` KV heads)."""

    num_heads: int = 16
    num_heads_kv: int = 4
    head_dim: int | None = None  # derived from d_model when None
    rotary_emb_dim: int | None = None
    qkv_proj_bias: bool = False
    out_proj_bias: bool = False
    extra: tuple = ()


@dataclasses.dataclass(frozen=True)
class BackboneConfig:
    """Backbone architecture config."""

    d_model: int = 1024
    d_intermediate: int = 0
    attn_mlp_d_intermediate: int = 0
    n_layer: int = 16
    ssm_cfg: object | None = None  # a Mamba2 config makes the backbone hybrid
    attn_layer_idx: tuple[int, ...] = ()
    attn_cfg: AttentionConfig | None = None
    rms_norm: bool = False
    residual_in_fp32: bool = False
    norm_epsilon: float = 1e-5

    @property
    def is_hybrid(self) -> bool:
        return self.ssm_cfg is not None

    @property
    def head_dim(self) -> int:
        assert self.attn_cfg is not None
        return self.attn_cfg.head_dim or self.d_model // self.attn_cfg.num_heads


@dataclasses.dataclass(frozen=True)
class ConditionerSpec:
    """One entry of the prefix conditioner's list."""

    type: str
    name: str
    cond_dim: int | None = None
    projection: Literal["none", "linear", "mlp"] = "none"
    uncond_type: Literal["learned", "none"] = "none"
    input_dim: int = 1
    std: float = 1.0
    min_val: float = 0.0
    max_val: float = 1.0
    extra: tuple = ()


@dataclasses.dataclass(frozen=True)
class PrefixConditionerConfig:
    conditioners: tuple[ConditionerSpec, ...]
    projection: Literal["none", "linear", "mlp"]


@dataclasses.dataclass(frozen=True)
class ZonosConfig:
    """Top-level model config."""

    backbone: BackboneConfig
    prefix_conditioner: PrefixConditionerConfig
    eos_token_id: int = 1024
    masked_token_id: int = 1025
    pad_vocab_to_multiple_of: int = 8
    codebook_dimension: int = 9

    @property
    def vocab_size(self) -> int:
        """Embedding vocab: 1024 DAC codes + EOS + MASK, padded to a multiple of 8."""
        base = self.masked_token_id + 1
        m = self.pad_vocab_to_multiple_of or 1
        return ((base + m - 1) // m) * m

    @property
    def head_vocab_size(self) -> int:
        """Per-codebook logits: 1024 codes + EOS."""
        return self.eos_token_id + 1


def _default_conditioners() -> tuple[ConditionerSpec, ...]:
    return (
        ConditionerSpec(type="EspeakPhonemeConditioner", name="espeak"),
        ConditionerSpec(
            type="PassthroughConditioner", name="speaker", cond_dim=128,
            projection="linear", uncond_type="learned",
        ),
        ConditionerSpec(type="FourierConditioner", name="emotion", input_dim=8, uncond_type="learned"),
        ConditionerSpec(
            type="FourierConditioner", name="fmax", min_val=0.0, max_val=24000.0,
            uncond_type="learned",
        ),
        ConditionerSpec(
            type="FourierConditioner", name="pitch_std", min_val=0.0, max_val=400.0,
            uncond_type="learned",
        ),
        ConditionerSpec(
            type="FourierConditioner", name="speaking_rate", min_val=0.0, max_val=40.0,
            uncond_type="learned",
        ),
        ConditionerSpec(
            type="IntegerConditioner", name="language_id", min_val=-1, max_val=126,
            uncond_type="learned",
        ),
    )


def zonos_v01_transformer_config() -> ZonosConfig:
    """Zonos-v0.1-transformer architecture (~1.6B params): d_model 2048, 24 layers,
    16 query / 4 KV heads of dim 128, gated MLP width 8192."""
    return ZonosConfig(
        backbone=BackboneConfig(
            d_model=2048,
            d_intermediate=0,
            attn_mlp_d_intermediate=8192,
            n_layer=24,
            ssm_cfg=None,
            attn_layer_idx=tuple(range(24)),
            attn_cfg=AttentionConfig(num_heads=16, num_heads_kv=4),
            rms_norm=False,
            residual_in_fp32=False,
            norm_epsilon=1e-5,
        ),
        prefix_conditioner=PrefixConditionerConfig(
            conditioners=_default_conditioners(), projection="none"
        ),
    )


def tiny_transformer_config(n_layer: int = 2, d_model: int = 64) -> ZonosConfig:
    """Tiny config for CPU unit tests."""
    return ZonosConfig(
        backbone=BackboneConfig(
            d_model=d_model,
            attn_mlp_d_intermediate=2 * d_model,
            n_layer=n_layer,
            attn_layer_idx=tuple(range(n_layer)),
            attn_cfg=AttentionConfig(num_heads=4, num_heads_kv=2),
        ),
        prefix_conditioner=PrefixConditionerConfig(
            conditioners=_default_conditioners(), projection="none"
        ),
    )


@dataclasses.dataclass(frozen=True)
class DACConfig:
    """Architecture of descript/dac_44khz (HF DacConfig field names)."""

    encoder_hidden_size: int = 64
    downsampling_ratios: tuple[int, ...] = (2, 4, 8, 8)
    decoder_hidden_size: int = 1536
    upsampling_ratios: tuple[int, ...] = (8, 8, 4, 2)
    n_codebooks: int = 9
    codebook_size: int = 1024
    codebook_dim: int = 8
    hidden_size: int = 1024
    sampling_rate: int = 44100

    @property
    def hop_length(self) -> int:
        return math.prod(self.downsampling_ratios)
