"""Weight-only int8 quantization (port of ``zonos_tpu/ops/quant.py``).

A quantized weight is a dict ``{"q": int8 [..., K, N], "s": f32 [..., 1, N]}``:
symmetric, one scale per output channel over the contraction axis K.
``qeinsum`` accepts a plain or a quantized weight.
"""

from __future__ import annotations

import torch

from zonos_tpu_torch.ops.cuda_matmul import MAX_ROWS, int8_matmul

INT4_TODO = (
    "int4 weights (quantize(bits=4)) are not ported yet: see ROADMAP.md, "
    "'TPU kernels still to port', K4 int4_matmul"
)


def quantize_int8(w: torch.Tensor) -> dict:
    """Per-output-channel symmetric int8 over the contraction axis (-2)."""
    wf = w.float()
    amax = wf.abs().amax(dim=-2, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"q": q, "s": scale}


def is_quantized(w) -> bool:
    return isinstance(w, dict) and "q" in w


def dequantize(w) -> torch.Tensor:
    if not is_quantized(w):
        return w
    return (w["q"].float() * w["s"]).to(torch.bfloat16)


def qeinsum(eq: str, x: torch.Tensor, w) -> torch.Tensor:
    """einsum(eq, x, w) for a plain or int8-quantized w; the output channel is last.

    Decode-shaped inputs (x [B, 1, K] with B <= 16, a 2-D weight) go to the
    int8 GEMV kernel K1. Everything else (the prefill) dequantizes the int8
    operand to x's dtype at the product and applies the scale after it, as
    JAX's XLA path does.
    """
    if isinstance(w, dict) and "q4" in w:
        raise NotImplementedError(INT4_TODO)
    if not is_quantized(w):
        return torch.einsum(eq, x, w)
    q, s = w["q"], w["s"]
    if x.dim() == 3 and x.shape[1] == 1 and q.dim() == 2 and x.shape[0] <= MAX_ROWS:
        return int8_matmul(x[:, 0].contiguous(), q, s)[:, None, :].to(x.dtype)
    y = torch.einsum(eq, x, q.to(x.dtype))
    return (y.float() * s.reshape(-1)).to(x.dtype)


def quantize_transformer_params(params: dict, bits: int = 8) -> dict:
    """Quantize the backbone's four matmuls per layer and the output heads.

    Embeddings and norms stay in the model dtype. Works on the layer-stacked
    layout: each [L, K, N] weight gets scales [L, 1, N].
    """
    if bits != 8:
        raise NotImplementedError(INT4_TODO)
    out = dict(params)
    bb = dict(params["backbone"])
    layers = dict(bb["layers"])
    attn = dict(layers["attn"])
    mlp = dict(layers["mlp"])
    attn["in_proj"] = quantize_int8(attn["in_proj"])
    attn["out_proj"] = quantize_int8(attn["out_proj"])
    mlp["fc1"] = quantize_int8(mlp["fc1"])
    mlp["fc2"] = quantize_int8(mlp["fc2"])
    layers["attn"], layers["mlp"] = attn, mlp
    bb["layers"] = layers
    out["backbone"] = bb
    out["heads"] = quantize_int8(params["heads"])
    return out
