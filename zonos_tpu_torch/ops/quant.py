"""Weight-only int8 and int4 quantization (port of ``zonos_tpu/ops/quant.py``).

An int8 weight is a dict ``{"q": int8 [..., K, N], "s": f32 [..., 1, N]}``:
symmetric, one scale per output channel over the contraction axis K. An int4
weight is ``{"q4": uint8 [..., G, group/2, N], "s4": f32 [..., G, 1, N]}``:
symmetric per (group of K, output channel), two values packed to a byte.
``qeinsum`` accepts a plain or a quantized weight.
"""

from __future__ import annotations

import torch

from zonos_tpu_torch.ops.cuda_matmul import int4_matmul, int8_matmul, unpack_nibbles


def quantize_int8(w: torch.Tensor) -> dict:
    """Per-output-channel symmetric int8 over the contraction axis (-2)."""
    wf = w.float()
    amax = wf.abs().amax(dim=-2, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"q": q, "s": scale}


def pad_rows16(q: torch.Tensor) -> torch.Tensor:
    """An int8 [K, N] weight as a [K, N] view whose row stride is N rounded up
    to 16 bytes (zeros in the padding), so that K1 fills its ring by 16-byte
    copies. Values, shape and the plain versions' results are unchanged."""
    k, n = q.shape
    ld = -(-n // 16) * 16
    if ld == n and q.is_contiguous():
        return q
    buf = torch.zeros((k, ld), dtype=q.dtype, device=q.device)
    buf[:, :n] = q
    return buf[:, :n]


def is_quantized(w) -> bool:
    return isinstance(w, dict) and "q" in w


def quantize_int4(w: torch.Tensor, group: int = 128) -> dict:
    """Group-wise symmetric int4 over the contraction axis, nibble-packed.

    K is split into groups of ``min(group, K)``; each (group, output channel)
    gets its own scale, values are clipped to ±7 and stored as two's-complement
    nibbles, row j of a group in the low nibble and row j + group/2 in the high
    one. Bit-identical to the JAX package's ``quantize_int4``.
    """
    *lead, k, n = w.shape
    group = min(group, k)
    if k % group or group % 2:
        raise ValueError(f"quantize_int4: K {k} must split into even groups of {group}")
    wf = w.float().reshape(*lead, k // group, group, n)
    amax = wf.abs().amax(dim=-2, keepdim=True)
    scale = torch.where(amax > 0, amax / 7.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / scale), -7, 7).to(torch.int32)
    u = torch.where(q < 0, q + 16, q).to(torch.uint8)
    half = group // 2
    return {"q4": u[..., :half, :] | (u[..., half:, :] << 4), "s4": scale}


def is_quantized4(w) -> bool:
    return isinstance(w, dict) and "q4" in w


def q4einsum_lastdim(x: torch.Tensor, w: dict, out_dtype=None) -> torch.Tensor:
    """y = x @ dequant(w) for a packed-int4 weight: [..., K] → [..., N].

    Decode-shaped inputs (x [B, 1, K], any B, a 3-D q4) go to the int4
    GEMV kernel K4. Everything else (the prefill) unpacks to x's dtype, runs
    the per-group product, scales each group's sum in f32 and adds the groups,
    as JAX's XLA path does.
    """
    q, s = w["q4"], w["s4"]
    out_dtype = out_dtype or x.dtype
    if x.dim() == 3 and x.shape[1] == 1 and q.dim() == 3:
        return int4_matmul(x[:, 0].contiguous(), q, s)[:, None, :].to(out_dtype)
    g, grp = q.shape[-3], q.shape[-2] * 2
    xg = x.reshape(*x.shape[:-1], g, grp)
    y = torch.einsum("...gk,gkn->...gn", xg, unpack_nibbles(q, x.dtype))
    return (y.float() * s[..., 0, :]).sum(dim=-2).to(out_dtype)


def dequantize(w) -> torch.Tensor:
    """An int8 or int4 weight → its bf16 values ([..., K, N]); a plain one as it is."""
    if is_quantized4(w):
        *lead, g, half, n = w["q4"].shape
        vals = unpack_nibbles(w["q4"], torch.float32) * w["s4"]
        return vals.reshape(*lead, g * 2 * half, n).to(torch.bfloat16)
    if not is_quantized(w):
        return w
    return (w["q"].float() * w["s"]).to(torch.bfloat16)


def qeinsum(eq: str, x: torch.Tensor, w, out_dtype=None) -> torch.Tensor:
    """einsum(eq, x, w) for a plain, int8 or int4 w; the output channel is last.
    The result is in ``out_dtype`` (default x's): f32 keeps a kernel's or the
    scaled product's f32 values unrounded (a plain w's product is x's dtype).

    int4 weights go to ``q4einsum_lastdim`` (every call site contracts x's last
    axis). For int8, decode-shaped inputs (x [B, 1, K], any B, a 2-D
    weight) go to the int8 GEMV kernel K1; everything else (the prefill)
    dequantizes the int8 operand to x's dtype at the product and applies the
    scale after it, as JAX's XLA path does.
    """
    out_dtype = out_dtype or x.dtype
    if is_quantized4(w):
        return q4einsum_lastdim(x, w, out_dtype)
    if not is_quantized(w):
        return torch.einsum(eq, x, w).to(out_dtype)
    q, s = w["q"], w["s"]
    if x.dim() == 3 and x.shape[1] == 1 and q.dim() == 2:
        return int8_matmul(x[:, 0].contiguous(), q, s)[:, None, :].to(out_dtype)
    y = torch.einsum(eq, x, q.to(x.dtype))
    return (y.float() * s.reshape(-1)).to(out_dtype)


def quantize_transformer_params(params: dict, bits: int = 8) -> dict:
    """Quantize the backbone's four matmuls per layer and the output heads.

    ``bits=8`` makes the four matmuls int8, ``bits=4`` group-wise int4 (group
    128); the heads stay int8 either way, their rows padded to 16 bytes
    (``pad_rows16``). Embeddings and norms stay in the model dtype. Works on
    the layer-stacked layout.
    """
    if bits not in (4, 8):
        raise ValueError(f"quantize: bits must be 4 or 8, got {bits}")
    quant = quantize_int8 if bits == 8 else quantize_int4
    out = dict(params)
    bb = dict(params["backbone"])
    layers = dict(bb["layers"])
    attn = dict(layers["attn"])
    mlp = dict(layers["mlp"])
    attn["in_proj"] = quant(attn["in_proj"])
    attn["out_proj"] = quant(attn["out_proj"])
    mlp["fc1"] = quant(mlp["fc1"])
    mlp["fc2"] = quant(mlp["fc2"])
    layers["attn"], layers["mlp"] = attn, mlp
    bb["layers"] = layers
    out["backbone"] = bb
    out["heads"] = _int8_heads(params["heads"])
    return out


def _int8_heads(heads: torch.Tensor) -> dict:
    """The output heads as int8, rows padded to 16 bytes for K1 (``pad_rows16``)."""
    q = quantize_int8(heads)
    return {"q": pad_rows16(q["q"]), "s": q["s"]}


def quantize_hybrid_params(params: dict, bits: int = 8) -> dict:
    """Quantize the hybrid backbone's mixer projections (Mamba2 and attention
    in_proj and out_proj) and MLPs, int8 (``bits=8``) or group-wise int4
    (``bits=4``), and the heads to int8 either way. Stacked Mamba runs keep
    their leading run axis (the scales gain it too). Conv taps, norms, biases
    and the SSD scalars stay as they are."""
    if bits not in (4, 8):
        raise ValueError(f"quantize: bits must be 4 or 8, got {bits}")
    quant = quantize_int8 if bits == 8 else quantize_int4
    groups = []
    for group in params["backbone"]["groups"]:
        group = dict(group)
        mixer = dict(group["mixer"])
        for k in ("in_proj", "out_proj"):
            if isinstance(mixer.get(k), torch.Tensor):
                mixer[k] = quant(mixer[k])
        group["mixer"] = mixer
        if group.get("mlp") is not None:
            group["mlp"] = {"fc1": quant(group["mlp"]["fc1"]), "fc2": quant(group["mlp"]["fc2"])}
        groups.append(group)
    return {**params, "backbone": {**params["backbone"], "groups": groups}, "heads": _int8_heads(params["heads"])}
