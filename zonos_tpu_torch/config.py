"""Model configuration dataclasses for the PyTorch/CUDA port.

The port's own copy of ``zonos_tpu/config.py`` and of the ``DACConfig`` of
``zonos_tpu/codec/dac.py``: same field names, defaults and presets, so a
configuration means the same model in both packages. ``ZonosConfig.from_dict``
reads the Hugging Face ``config.json`` of a Zonos checkpoint (unknown keys of
a sub-config are kept in its ``extra``), and ``config_to_dict`` writes the dict
form that the JAX package's ``checkpoint._config_to_dict`` writes, so a
``config.json`` written by one package is read by the other. The port imports
nothing of ``zonos_tpu``.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Literal, Mapping


def _freeze(value: Any) -> Any:
    """Lists and dicts → hashable tuples, for the frozen configs' ``extra``."""
    if isinstance(value, Mapping):
        return tuple(sorted((k, _freeze(v)) for k, v in value.items()))
    if isinstance(value, (list, tuple)):
        return tuple(_freeze(v) for v in value)
    return value


def _split(cls, d: Mapping[str, Any]) -> tuple[dict, tuple]:
    """(the dataclass's own fields, everything else frozen as ``extra``). An
    ``extra`` entry, as ``config_to_dict`` writes it, is read back as the
    extra keys it holds, so a config survives any number of JSON round trips."""
    d = dict(d)
    stored = {k: v for k, v in d.pop("extra", None) or ()}
    names = {f.name for f in dataclasses.fields(cls)} - {"extra"}
    known = {k: d.pop(k) for k in list(d) if k in names}
    return known, _freeze({**stored, **d})


def config_to_dict(obj: Any) -> Any:
    """A config dataclass → nested dicts and lists (tuples become lists), the
    form JSON holds and ``from_dict`` reads back. A field marked
    ``omit_default`` is left out while it holds its default, so a config
    that does not use it writes the dict it wrote before the field existed."""
    if dataclasses.is_dataclass(obj):
        return {f.name: config_to_dict(getattr(obj, f.name)) for f in dataclasses.fields(obj)
                if not (f.metadata.get("omit_default") and getattr(obj, f.name) == f.default)}
    if isinstance(obj, (list, tuple)):
        return [config_to_dict(v) for v in obj]
    return obj


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

    @classmethod
    def from_dict(cls, d: Mapping[str, Any] | None) -> "AttentionConfig | None":
        if not d:
            return None
        known, extra = _split(cls, d)
        return cls(extra=extra, **known)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 sub-config (mamba-ssm's Mamba2 field names and defaults).

    ``dt_limit``: the softplus'd timestep is clamped to this range; the
    default (0, inf) clamps nothing, as in mamba-ssm.
    """

    layer: str = "Mamba2"
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64
    ngroups: int = 1
    chunk_size: int = 256
    dt_limit: tuple = (0.0, float("inf"))
    extra: tuple = ()

    @classmethod
    def from_dict(cls, d: Mapping[str, Any] | None) -> "SSMConfig | None":
        if not d:
            return None
        known, extra = _split(cls, d)
        if "dt_limit" in known:
            known["dt_limit"] = tuple(known["dt_limit"])
        return cls(extra=extra, **known)


def _setting(default: float | bool | None = 1.0):
    """A setting that only some checkpoints carry (``omit_default``)."""
    return dataclasses.field(default=default, metadata={"omit_default": True})


@dataclasses.dataclass(frozen=True)
class BackboneConfig:
    """Backbone architecture config.

    The four scalars carry Granite 4.0's published names and meanings, and
    the hybrid backbone applies them (at 1.0 each does nothing):
    ``embedding_multiplier`` scales the backbone's whole input,
    ``residual_multiplier`` every mixer and MLP branch before it joins the
    residual stream, ``attention_multiplier`` replaces the softmax scale
    1/sqrt(head_dim) where it is not None, and the final hidden state is
    divided by ``logits_scaling`` before the (linear, bias-free) heads.
    ``rms_norm_f`` makes the final norm an RMSNorm, as Granite's is; Zonos's
    is a LayerNorm even where ``rms_norm`` makes every block's norm an RMSNorm.
    """

    d_model: int = 1024
    d_intermediate: int = 0
    attn_mlp_d_intermediate: int = 0
    n_layer: int = 16
    ssm_cfg: SSMConfig | None = None  # a Mamba2 config makes the backbone hybrid
    attn_layer_idx: tuple[int, ...] = ()
    attn_cfg: AttentionConfig | None = None
    rms_norm: bool = False
    residual_in_fp32: bool = False
    norm_epsilon: float = 1e-5
    embedding_multiplier: float = _setting()
    residual_multiplier: float = _setting()
    attention_multiplier: float | None = _setting(None)
    logits_scaling: float = _setting()
    rms_norm_f: bool = _setting(False)

    @property
    def is_hybrid(self) -> bool:
        return self.ssm_cfg is not None

    @property
    def head_dim(self) -> int:
        assert self.attn_cfg is not None
        return self.attn_cfg.head_dim or self.d_model // self.attn_cfg.num_heads

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "BackboneConfig":
        d = dict(d)
        d["ssm_cfg"] = SSMConfig.from_dict(d.get("ssm_cfg"))
        d["attn_cfg"] = AttentionConfig.from_dict(d.get("attn_cfg"))
        d["attn_layer_idx"] = tuple(d.get("attn_layer_idx") or ())
        return cls(**d)


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

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ConditionerSpec":
        known, extra = _split(cls, d)
        return cls(extra=extra, **known)


@dataclasses.dataclass(frozen=True)
class PrefixConditionerConfig:
    conditioners: tuple[ConditionerSpec, ...]
    projection: Literal["none", "linear", "mlp"]

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "PrefixConditionerConfig":
        return cls(conditioners=tuple(ConditionerSpec.from_dict(c) for c in d["conditioners"]),
                   projection=d["projection"])


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

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ZonosConfig":
        d = dict(d)
        backbone = BackboneConfig.from_dict(d.pop("backbone"))
        prefix = PrefixConditionerConfig.from_dict(d.pop("prefix_conditioner"))
        return cls(backbone, prefix, **d)

    @classmethod
    def from_json(cls, path: str) -> "ZonosConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))


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


def _hybrid_conditioners() -> tuple[ConditionerSpec, ...]:
    """The hybrid model's set: the transformer's and vqscore_8, ctc_loss,
    dnsmos_ovrl and speaker_noised."""
    return _default_conditioners() + (
        ConditionerSpec(
            type="FourierConditioner", name="vqscore_8", input_dim=8, min_val=0.5, max_val=0.8,
            uncond_type="learned",
        ),
        ConditionerSpec(
            type="FourierConditioner", name="ctc_loss", min_val=-1.0, max_val=1000.0, uncond_type="learned",
        ),
        ConditionerSpec(
            type="FourierConditioner", name="dnsmos_ovrl", min_val=1.0, max_val=5.0, uncond_type="learned",
        ),
        ConditionerSpec(
            type="IntegerConditioner", name="speaker_noised", min_val=0, max_val=1, uncond_type="learned",
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


def zonos_v01_hybrid_config() -> ZonosConfig:
    """Zonos-v0.1-hybrid architecture (~1.3B params): d_model 2048, 24 layers,
    Mamba2 mixers (d_state 128, headdim 64) with MLP width 4096, and attention
    at layers 3, 9, 15 and 21 (16 query / 4 KV heads) with MLP width 8192."""
    return ZonosConfig(
        backbone=BackboneConfig(
            d_model=2048,
            d_intermediate=4096,
            attn_mlp_d_intermediate=8192,
            n_layer=24,
            ssm_cfg=SSMConfig(),
            attn_layer_idx=(3, 9, 15, 21),
            attn_cfg=AttentionConfig(num_heads=16, num_heads_kv=4),
            rms_norm=False,
            residual_in_fp32=False,
            norm_epsilon=1e-5,
        ),
        prefix_conditioner=PrefixConditionerConfig(
            conditioners=_hybrid_conditioners(), projection="none"
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


def tiny_hybrid_config(n_layer: int = 3, d_model: int = 64) -> ZonosConfig:
    """Tiny hybrid (Mamba2 + one attention layer) config for CPU unit tests."""
    return ZonosConfig(
        backbone=BackboneConfig(
            d_model=d_model,
            d_intermediate=2 * d_model,
            attn_mlp_d_intermediate=2 * d_model,
            n_layer=n_layer,
            ssm_cfg=SSMConfig(d_state=16, headdim=16, chunk_size=8),
            attn_layer_idx=(1,),
            attn_cfg=AttentionConfig(num_heads=4, num_heads_kv=2),
        ),
        prefix_conditioner=PrefixConditionerConfig(
            conditioners=_hybrid_conditioners(), projection="none"
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
