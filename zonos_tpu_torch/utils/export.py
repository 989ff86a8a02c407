"""The port's params → the reference checkpoint layout (port of
``zonos_tpu/utils/export.py``).

The inverse of ``utils.loading``: layer-stacked leaves become one tensor per
layer under ``backbone.layers.N...``, linears go back to [out, in], the
heads are written fused and the embeddings with the reference's 1026 rows.
Quantized leaves (int8 ``{"q","s"}``, int4 ``{"q4","s4"}``) are dequantized
to their bf16 values first, as the JAX package does for int8.
``save_reference_checkpoint`` writes bf16, except the leaves a model keeps in
f32 whatever its dtype (the Mamba2 SSD scalars ``A_log``, ``D``, ``dt_bias``
and the Fourier conditioners' weights), which it writes as F32 so that a
bf16 model reads back bit for bit; the JAX package writes those as bf16 too.
"""

from __future__ import annotations

import json
import os
from typing import Any, Mapping

import torch

from zonos_tpu_torch.config import ZonosConfig, config_to_dict
from zonos_tpu_torch.models.hybrid import layer_groups
from zonos_tpu_torch.ops.quant import dequantize
from zonos_tpu_torch.utils.safetensors_io import save_file

_REF_EMB_ROWS = 1026  # rows the reference keeps per codebook embedding: 1024 codes + EOS + MASK


def params_to_torch_state_dict(params: Mapping[str, Any], cfg: ZonosConfig,
                               dtype=torch.float32) -> dict[str, torch.Tensor]:
    """The port's params → a reference-layout state dict of ``dtype`` tensors
    (the leaves a model keeps in f32, SSD scalars and Fourier weights, stay
    f32), contiguous, on the params' device."""
    def f(x, f32: bool = False):
        return dequantize(x).to(torch.float32 if f32 else dtype).contiguous()

    def t(x):
        return f(x).transpose(-1, -2).contiguous()  # [in, out] → [out, in]; stacked leaves keep their axis

    sd: dict[str, torch.Tensor] = {}
    emb = f(params["embeddings"])
    for k in range(cfg.codebook_dimension):
        sd[f"embeddings.{k}.weight"] = emb[k, :_REF_EMB_ROWS].contiguous()
    sd["fused_heads.weight"] = t(params["heads"])
    bb = params["backbone"]
    if cfg.backbone.is_hybrid:
        _export_hybrid(sd, bb, cfg, f, t)
    else:
        lay = bb["layers"]
        stacked = {"norm.weight": f(lay["norm1"]["scale"]), "norm.bias": f(lay["norm1"]["bias"]),
                   "mixer.in_proj.weight": t(lay["attn"]["in_proj"]),
                   "mixer.out_proj.weight": t(lay["attn"]["out_proj"]),
                   "norm2.weight": f(lay["norm2"]["scale"]), "norm2.bias": f(lay["norm2"]["bias"]),
                   "mlp.fc1.weight": t(lay["mlp"]["fc1"]), "mlp.fc2.weight": t(lay["mlp"]["fc2"])}
        for i in range(cfg.backbone.n_layer):
            for name, v in stacked.items():
                sd[f"backbone.layers.{i}.{name}"] = v[i].contiguous()
    sd["backbone.norm_f.weight"] = f(bb["norm_f"]["scale"])
    sd["backbone.norm_f.bias"] = f(bb["norm_f"]["bias"])
    _export_conditioner(sd, params["prefix_conditioner"], cfg, f, t)
    return sd


def _export_hybrid(sd, bb, cfg: ZonosConfig, f, t) -> None:
    def layer_tensors(p) -> dict:
        out = {"norm.weight": f(p["norm"]["scale"])}
        if p["norm"].get("bias") is not None:
            out["norm.bias"] = f(p["norm"]["bias"])
        m = p["mixer"]
        out["mixer.in_proj.weight"] = t(m["in_proj"])
        out["mixer.out_proj.weight"] = t(m["out_proj"])
        if "conv_w" in m:  # Mamba2: taps [K, C] → depthwise conv1d [C, 1, K]
            out["mixer.conv1d.weight"] = f(m["conv_w"]).transpose(-1, -2).unsqueeze(-2).contiguous()
            out["mixer.conv1d.bias"] = f(m["conv_b"])
            for name in ("A_log", "D", "dt_bias"):
                out[f"mixer.{name}"] = f(m[name], f32=True)
            out["mixer.norm.weight"] = f(m["norm_w"])
        for name in ("in_proj", "out_proj"):
            if m.get(f"{name}_b") is not None:
                out[f"mixer.{name}.bias"] = f(m[f"{name}_b"])
        if p.get("mlp") is not None:
            out["norm2.weight"] = f(p["norm2"]["scale"])
            if p["norm2"].get("bias") is not None:
                out["norm2.bias"] = f(p["norm2"]["bias"])
            out["mlp.fc1.weight"] = t(p["mlp"]["fc1"])
            out["mlp.fc2.weight"] = t(p["mlp"]["fc2"])
        return out

    nxt = 0
    for g, (kind, v) in zip(bb["groups"], layer_groups(cfg.backbone)):
        tensors = layer_tensors(g)  # a Mamba run's tensors keep their run axis: sliced below
        layers = [(v, None)] if kind == "attn" else [(nxt + j, j) for j in range(v)]
        for i, j in layers:
            for name, x in tensors.items():
                sd[f"backbone.layers.{i}.{name}"] = x if j is None else x[j].contiguous()
        nxt = v + 1 if kind == "attn" else nxt + v


def _export_projection(sd, base: str, kind: str, p: Mapping[str, Any], f, t) -> None:
    if kind == "linear":
        sd[f"{base}.weight"], sd[f"{base}.bias"] = t(p["w"]), f(p["b"])
    elif kind == "mlp":
        sd[f"{base}.0.weight"], sd[f"{base}.0.bias"] = t(p["w1"]), f(p["b1"])
        sd[f"{base}.2.weight"], sd[f"{base}.2.bias"] = t(p["w2"]), f(p["b2"])


def _export_conditioner(sd, pc, cfg: ZonosConfig, f, t) -> None:
    for i, spec in enumerate(cfg.prefix_conditioner.conditioners):
        base = f"prefix_conditioner.conditioners.{i}"
        p = pc[spec.name]
        if spec.type == "EspeakPhonemeConditioner":
            sd[f"{base}.phoneme_embedder.weight"] = f(p["phoneme_embed"])
        elif spec.type == "FourierConditioner":
            sd[f"{base}.weight"] = f(p["fourier_weight"], f32=True)
        elif spec.type == "IntegerConditioner":
            sd[f"{base}.int_embedder.weight"] = f(p["int_embed"])
        _export_projection(sd, f"{base}.project", spec.projection, p.get("project", {}), f, t)
        if spec.uncond_type == "learned":
            sd[f"{base}.uncond_vector"] = f(p["uncond_vector"])
    _export_projection(sd, "prefix_conditioner.project", cfg.prefix_conditioner.projection,
                       pc.get("_project", {}), f, t)
    sd["prefix_conditioner.norm.weight"] = f(pc["_norm"]["scale"])
    sd["prefix_conditioner.norm.bias"] = f(pc["_norm"]["bias"])


def save_reference_checkpoint(out_dir: str, params: Mapping[str, Any], cfg: ZonosConfig) -> tuple[str, str]:
    """Write ``model.safetensors`` (reference layout; bf16 but for the f32
    leaves) and ``config.json`` into ``out_dir``; returns (weights path, config path)."""
    os.makedirs(out_dir, exist_ok=True)
    wpath = os.path.join(out_dir, "model.safetensors")
    save_file(params_to_torch_state_dict(params, cfg, dtype=torch.bfloat16), wpath)
    cpath = os.path.join(out_dir, "config.json")
    with open(cpath, "w") as fh:
        json.dump(config_to_dict(cfg), fh, indent=2)
    return wpath, cpath
