"""Conditioning modules: Fourier / Integer / Passthrough / Phoneme + PrefixConditioner
(port of ``zonos_tpu/conditioning/conditioners.py``).

Each conditioner is a function over its params sub-tree (the JAX layout). The
prefix conditioner concatenates all conditioner outputs along the sequence
axis, applies the configured projection and LayerNorms the result.
Phonemization and tokenization run on the host; the embedding tensor they
produce lives on the params' device.
"""

from __future__ import annotations

import math
from typing import Any, Mapping

import numpy as np
import torch

from zonos_tpu_torch.conditioning import espeak
from zonos_tpu_torch.conditioning.text import PHONEME_VOCAB_SIZE, tokenize_phonemes
from zonos_tpu_torch.config import ConditionerSpec, PrefixConditionerConfig
from zonos_tpu_torch.ops.norms import layer_norm


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32, device=device)


def _init_projection(gen, spec_projection: str, cond_dim: int, output_dim: int, dtype, device) -> dict:
    zeros = lambda n: torch.zeros((n,), dtype=dtype, device=device)  # noqa: E731
    if spec_projection == "linear":
        return {"w": (_normal(gen, (cond_dim, output_dim), device) / math.sqrt(cond_dim)).to(dtype),
                "b": zeros(output_dim)}
    if spec_projection == "mlp":
        return {
            "w1": (_normal(gen, (cond_dim, output_dim), device) / math.sqrt(cond_dim)).to(dtype),
            "b1": zeros(output_dim),
            "w2": (_normal(gen, (output_dim, output_dim), device) / math.sqrt(output_dim)).to(dtype),
            "b2": zeros(output_dim),
        }
    return {}


def _apply_projection(proj: dict, x: torch.Tensor) -> torch.Tensor:
    if "w1" in proj:
        h = x @ proj["w1"].to(x.dtype) + proj["b1"].to(x.dtype)
        h = torch.nn.functional.silu(h)
        return h @ proj["w2"].to(x.dtype) + proj["b2"].to(x.dtype)
    if "w" in proj:
        return x @ proj["w"].to(x.dtype) + proj["b"].to(x.dtype)
    return x


def init_conditioner_params(gen: torch.Generator, spec: ConditionerSpec, output_dim: int,
                            dtype=torch.bfloat16, device=None) -> dict:
    """One conditioner's params (embedder + projection + learned uncond vector)."""
    cond_dim = spec.cond_dim or output_dim
    params: dict[str, Any] = {}
    if spec.type == "EspeakPhonemeConditioner":
        params["phoneme_embed"] = (_normal(gen, (PHONEME_VOCAB_SIZE, output_dim), device) * 0.02).to(dtype)
        cond_dim = output_dim
    elif spec.type == "FourierConditioner":
        if output_dim % 2:
            raise ValueError(f"FourierConditioner {spec.name}: output_dim {output_dim} must be even")
        # A checkpointed buffer in the reference; random here, kept f32.
        params["fourier_weight"] = _normal(gen, (output_dim // 2, spec.input_dim), device) * spec.std
        cond_dim = output_dim
    elif spec.type == "IntegerConditioner":
        n = int(spec.max_val) - int(spec.min_val) + 1
        params["int_embed"] = (_normal(gen, (n, output_dim), device) * 0.02).to(dtype)
        cond_dim = output_dim
    elif spec.type != "PassthroughConditioner":
        raise KeyError(f"Unknown conditioner type: {spec.type}")

    params["project"] = _init_projection(gen, spec.projection, cond_dim, output_dim, dtype, device)
    if spec.uncond_type == "learned":
        params["uncond_vector"] = torch.zeros((output_dim,), dtype=dtype, device=device)
    return params


def init_prefix_conditioner_params(gen: torch.Generator, cfg: PrefixConditionerConfig, output_dim: int,
                                   dtype=torch.bfloat16, device=None) -> dict:
    params = {spec.name: init_conditioner_params(gen, spec, output_dim, dtype, device) for spec in cfg.conditioners}
    params["_project"] = _init_projection(gen, cfg.projection, output_dim, output_dim, dtype, device)
    params["_norm"] = {"scale": torch.ones((output_dim,), dtype=dtype, device=device),
                       "bias": torch.zeros((output_dim,), dtype=dtype, device=device)}
    return params


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _as_batched(x: Any, device) -> torch.Tensor:
    """Coerce a host value or tensor to a [B, S, C] tensor (make_cond_dict's shape)."""
    t = x.to(device) if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x), device=device)
    if t.dim() == 0:
        return t.reshape(1, 1, 1)
    if t.dim() == 1:
        return t.reshape(1, 1, -1)
    if t.dim() == 2:
        return t[None]
    return t


def conditioner_forward(params: dict, spec: ConditionerSpec, value: Any, dtype=torch.bfloat16,
                        device=None) -> torch.Tensor:
    """Apply one conditioner → [B, S, output_dim] on ``device``. value None → the learned uncond vector."""
    if value is None:
        if "uncond_vector" not in params:
            raise ValueError(f"conditioner {spec.name} has no uncond vector")
        return params["uncond_vector"].reshape(1, 1, -1).to(dtype)

    if spec.type == "EspeakPhonemeConditioner":
        texts, languages = value
        phonemes = espeak.phonemize(list(texts), list(languages))
        ids, _ = tokenize_phonemes(phonemes)
        cond = params["phoneme_embed"][torch.as_tensor(np.asarray(ids, np.int64), device=device)]
    elif spec.type == "FourierConditioner":
        x = _as_batched(value, device).float()
        if x.shape[-1] != spec.input_dim:
            raise ValueError(f"{spec.name}: expected {spec.input_dim} values, got shape {tuple(x.shape)}")
        x = (x - spec.min_val) / (spec.max_val - spec.min_val)
        f = 2 * math.pi * x @ params["fourier_weight"].float().T
        cond = torch.cat([torch.cos(f), torch.sin(f)], dim=-1)
    elif spec.type == "IntegerConditioner":
        x = _as_batched(value, device).to(torch.int64)
        if x.shape[-1] != 1:
            raise ValueError(f"{spec.name}: expected one integer, got shape {tuple(x.shape)}")
        cond = params["int_embed"][x[..., 0] - int(spec.min_val)]
    elif spec.type == "PassthroughConditioner":
        cond = _as_batched(value, device)
        if spec.cond_dim and cond.shape[-1] != spec.cond_dim:
            raise ValueError(f"{spec.name}: expected {spec.cond_dim} channels, got shape {tuple(cond.shape)}")
    else:
        raise KeyError(spec.type)
    return _apply_projection(params["project"], cond.to(dtype))


def prefix_conditioner_forward(params: dict, cfg: PrefixConditionerConfig, cond_dict: Mapping[str, Any],
                               dtype=torch.bfloat16, norm_eps: float = 1e-5) -> torch.Tensor:
    """Concatenate all conditioner outputs, project, LayerNorm → [B, Lc, D].

    Missing keys take each conditioner's learned unconditional vector.
    """
    missing = required_keys(cfg) - set(cond_dict)
    if missing:
        raise ValueError(f"Missing required keys: {missing}")
    device = params["_norm"]["scale"].device
    conds = [conditioner_forward(params[spec.name], spec, cond_dict.get(spec.name), dtype, device)
             for spec in cfg.conditioners]
    max_b = max(c.shape[0] for c in conds)
    if any(c.shape[0] not in (max_b, 1) for c in conds):
        raise ValueError(f"conditioner batch sizes {[c.shape[0] for c in conds]} do not broadcast")
    out = torch.cat([c.expand(max_b, *c.shape[1:]) for c in conds], dim=-2)
    out = _apply_projection(params["_project"], out)
    return layer_norm(out, params["_norm"]["scale"], params["_norm"]["bias"], norm_eps)


def required_keys(cfg: PrefixConditionerConfig) -> set[str]:
    """Conditioners without a learned uncond vector must always be given."""
    return {s.name for s in cfg.conditioners if s.uncond_type != "learned"}
