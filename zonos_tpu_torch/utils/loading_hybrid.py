"""The hybrid backbone's reference state dict → the port's params (port of
``zonos_tpu/utils/loading_hybrid.py``).

mamba-ssm's ``create_block`` naming, per layer i:

    backbone.layers.{i}.norm.{weight,bias}
    backbone.layers.{i}.mixer.in_proj.weight           # Mamba2 or attention
    backbone.layers.{i}.mixer.conv1d.{weight,bias}     # Mamba2: depthwise [C, 1, K]
    backbone.layers.{i}.mixer.{A_log,D,dt_bias}        # Mamba2
    backbone.layers.{i}.mixer.norm.weight              # Mamba2 gated RMSNorm
    backbone.layers.{i}.mixer.out_proj.weight
    backbone.layers.{i}.norm2.{weight,bias}            # where there is an MLP
    backbone.layers.{i}.mlp.{fc1,fc2}.weight
    backbone.norm_f.{weight,bias}

Each run of consecutive Mamba layers is stacked (``models.hybrid.stack_layers``).
"""

from __future__ import annotations

from typing import Mapping

import torch

from zonos_tpu_torch.config import ZonosConfig
from zonos_tpu_torch.models.hybrid import layer_groups, stack_layers
from zonos_tpu_torch.utils.loading import _Converter


def _layer_params(c: _Converter, i: int, is_attn: bool) -> dict:
    base = f"backbone.layers.{i}"

    def opt(key):
        return c.arr(key) if key in c.sd else None

    def norm_p(prefix):
        p = {"scale": c.arr(f"{prefix}.weight")}
        if f"{prefix}.bias" in c.sd:
            p["bias"] = c.arr(f"{prefix}.bias")
        return p

    m = f"{base}.mixer"
    if is_attn:
        mixer = {"in_proj": c.t(f"{m}.in_proj.weight"), "in_proj_b": opt(f"{m}.in_proj.bias"),
                 "out_proj": c.t(f"{m}.out_proj.weight"), "out_proj_b": opt(f"{m}.out_proj.bias")}
    else:
        mixer = {
            "in_proj": c.t(f"{m}.in_proj.weight"),
            "conv_w": c.arr(f"{m}.conv1d.weight")[:, 0, :].T.contiguous(),  # [C, 1, K] → taps [K, C]
            "conv_b": c.arr(f"{m}.conv1d.bias"),
            "A_log": c.arr(f"{m}.A_log", torch.float32),
            "D": c.arr(f"{m}.D", torch.float32),
            "dt_bias": c.arr(f"{m}.dt_bias", torch.float32),
            "norm_w": c.arr(f"{m}.norm.weight"),
            "out_proj": c.t(f"{m}.out_proj.weight"),
        }
    layer = {"norm": norm_p(f"{base}.norm"), "mixer": mixer, "norm2": None, "mlp": None}
    if f"{base}.mlp.fc1.weight" in c.sd:
        layer["norm2"] = norm_p(f"{base}.norm2")
        layer["mlp"] = {"fc1": c.t(f"{base}.mlp.fc1.weight"), "fc2": c.t(f"{base}.mlp.fc2.weight")}
    return layer


def hybrid_state_dict_to_params(sd: Mapping[str, torch.Tensor], cfg: ZonosConfig, dtype=torch.bfloat16,
                                device="cpu") -> dict:
    c = _Converter(sd, dtype, device)
    groups, nxt = [], 0
    for kind, v in layer_groups(cfg.backbone):
        if kind == "attn":
            groups.append(_layer_params(c, v, True))
            nxt = v + 1
        else:
            groups.append(stack_layers([_layer_params(c, nxt + j, False) for j in range(v)]))
            nxt += v
    return {"groups": groups,
            "norm_f": {"scale": c.arr("backbone.norm_f.weight"), "bias": c.arr("backbone.norm_f.bias")}}
