"""Turn the JAX package's params into the port's.

The input is a nested dict of numpy arrays (e.g. ``jax.tree.map(np.asarray,
params)``); the output holds torch tensors on one device. Layouts are kept:
layer-stacked ``[L, ...]`` leaves and ``{"q", "s"}`` int8 dicts pass through
unchanged, and so do ``{"q4", "s4"}`` int4 dicts, the ``prefix_conditioner``
subtree and the hybrid's ``groups`` (a list here; its stacked Mamba runs keep
their leading run axis and its absent MLPs and biases stay None). Only the
DAC's and the speaker tower's convolution and linear weights change layout,
to PyTorch's. This module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from zonos_tpu_torch.ops.quant import pad_rows16

# Float leaves the JAX package keeps in f32 whatever the model dtype: the
# int8 and int4 quant scales, the Fourier conditioners' projection and the
# Mamba2 mixers' SSD scalars.
F32_KEYS = frozenset({"s", "s4", "fourier_weight", "A_log", "D", "dt_bias"})


def _tensor(a, device, dtype, key: str | None) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind in "iub":
        return torch.from_numpy(np.array(a, copy=True)).to(device)
    # numpy has no bf16: widen first (exact); the F32_KEYS leaves stay f32.
    t = torch.from_numpy(np.array(a, dtype=np.float32, copy=True))
    return t.to(device=device, dtype=torch.float32 if key in F32_KEYS else dtype)


def params_from_jax(tree, device="cpu", dtype=torch.float32, _key: str | None = None):
    """Nested dict/list of numpy arrays → the same structure of torch tensors.

    Integer leaves (int8 weights, packed uint8 int4 weights) keep their
    dtype, the leaves named in ``F32_KEYS`` stay f32, and every other float
    leaf becomes ``dtype``. Int8 heads get rows padded to 16 bytes
    (``ops.quant.pad_rows16``), the port's layout for K1.
    """
    if isinstance(tree, dict):
        out = {k: params_from_jax(v, device, dtype, k) for k, v in tree.items()}
        heads = out.get("heads")
        if isinstance(heads, dict) and "q" in heads:  # int8 heads: rows padded to 16 bytes for K1
            out["heads"] = {**heads, "q": pad_rows16(heads["q"])}
        return out
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device, dtype, _key) for v in tree]
    return None if tree is None else _tensor(tree, device, dtype, _key)


def _conv(p: dict, device, dtype) -> dict:
    """JAX conv {"w": [K, Cin, Cout], "b"} → PyTorch's [Cout, Cin, K]."""
    w = np.asarray(p["w"], np.float32).transpose(2, 1, 0)
    return {"w": _tensor(w, device, dtype, "w"), "b": _tensor(p["b"], device, dtype, "b")}


def _conv_t(p: dict, device, dtype) -> dict:
    """JAX conv-transpose {"w": [K, Cin, Cout], K flipped} → PyTorch's [Cin, Cout, K].

    The JAX package stores the transposed-conv taps flipped along K (it runs
    them as an input-dilated forward convolution), so K is un-flipped here.
    """
    w = np.asarray(p["w"], np.float32)[::-1].transpose(1, 2, 0)
    return {"w": _tensor(w, device, dtype, "w"), "b": _tensor(p["b"], device, dtype, "b")}


def _res(p: dict, device, dtype) -> dict:
    return {
        "snake1": _tensor(p["snake1"], device, dtype, None),
        "conv1": _conv(p["conv1"], device, dtype),
        "snake2": _tensor(p["snake2"], device, dtype, None),
        "conv2": _conv(p["conv2"], device, dtype),
    }


def dac_params_from_jax(tree: dict, device="cpu", dtype=torch.float32) -> dict:
    """JAX DAC params (``init_dac_params`` layout) → the port's encoder, quantizer
    and decoder. A tree without ``encoder`` (decoder-only) gives none."""
    dec = tree["decoder"]
    decoder = {
        "conv1": _conv(dec["conv1"], device, dtype),
        "blocks": [
            {
                "snake1": _tensor(blk["snake1"], device, dtype, None),
                "conv_t": _conv_t(blk["conv_t"], device, dtype),
                "res": [_res(r, device, dtype) for r in blk["res"]],
            }
            for blk in dec["blocks"]
        ],
        "snake_out": _tensor(dec["snake_out"], device, dtype, None),
        "conv2": _conv(dec["conv2"], device, dtype),
    }
    q = tree["quantizer"]
    out = {"decoder": decoder, "quantizer": {k: _tensor(v, device, dtype, k) for k, v in q.items()}}
    if "encoder" in tree:
        enc = tree["encoder"]
        out["encoder"] = {
            "conv1": _conv(enc["conv1"], device, dtype),
            "blocks": [
                {
                    "res": [_res(r, device, dtype) for r in blk["res"]],
                    "snake1": _tensor(blk["snake1"], device, dtype, None),
                    "conv": _conv(blk["conv"], device, dtype),
                }
                for blk in enc["blocks"]
            ],
            "snake_out": _tensor(enc["snake_out"], device, dtype, None),
            "conv2": _conv(enc["conv2"], device, dtype),
        }
    return out


def _speaker_tree(tree, device):
    """Speaker leaves: 4-d HWIO conv weights (5-d when stacked) → OIHW, the rest as is."""
    if isinstance(tree, dict):
        return {k: _speaker_tree(v, device) for k, v in tree.items()}
    if tree is None:
        return None
    a = np.asarray(tree, np.float32)
    if a.ndim >= 4:  # [..., kh, kw, Cin, Cout] → [..., Cout, Cin, kh, kw]
        a = np.moveaxis(a, (-1, -2), (-4, -3))
    return _tensor(np.ascontiguousarray(a), device, torch.float32, None)


def speaker_params_from_jax(tree: dict, device="cpu") -> dict:
    """JAX speaker params (``speaker_state_dict_to_params`` layout, BN folded,
    ``rest`` blocks stacked) → the port's, float32: convs HWIO → OIHW and the
    ASP and bottleneck weights [in, out] → PyTorch's [out, in]."""
    stages = [{"first": _speaker_tree(st["first"], device), "rest": _speaker_tree(st["rest"], device)}
              for st in tree["resnet"]["stages"]]
    resnet = {"stem": _speaker_tree(tree["resnet"]["stem"], device), "stages": stages}

    def linear(p):
        return {"w": _tensor(np.asarray(p["w"], np.float32).T, device, torch.float32, None),
                "b": _tensor(p["b"], device, torch.float32, None)}

    asp = tree["asp"]
    return {
        "resnet": resnet,
        "asp": {"att_conv1": linear(asp["att_conv1"]), "att_bn": _speaker_tree(asp["att_bn"], device),
                "att_conv2": linear(asp["att_conv2"])},
        "bottleneck": linear(tree["bottleneck"]),
    }


def hybrid_cache_from_jax(cache, device="cpu"):
    """A JAX ``HybridCache`` (or any object with its fields, numpy values) →
    the port's ``models.hybrid.HybridCache``: the same layouts (head-major
    int8 KV with f32 scales, stacked [R, ...] conv and SSD states), dtypes
    kept; a ``[]`` scale tuple (a bf16 cache) becomes None per group."""
    from zonos_tpu_torch.models.hybrid import HybridCache

    def conv(seq):
        return [None if a is None else torch.from_numpy(np.array(a, copy=True)).to(device) for a in seq]

    n = len(cache.kv_k)
    return HybridCache(kv_k=conv(cache.kv_k), kv_v=conv(cache.kv_v), conv=conv(cache.conv), ssm=conv(cache.ssm),
                       kv_ks=conv(cache.kv_ks or [None] * n), kv_vs=conv(cache.kv_vs or [None] * n))


def lora_from_jax(tree: dict, device="cpu", dtype=torch.float32) -> dict:
    """A JAX LoRA adapter ``{"<target>": {"a": [L, in, r], "b": [L, r, out]}}``
    (numpy values) → the port's, the same layout, ``dtype`` factors."""
    return {target: {k: _tensor(v, device, dtype, k) for k, v in adapter.items()} for target, adapter in tree.items()}
