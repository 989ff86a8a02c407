"""Transformer backbone: layer-stacked params, static KV cache (port of
``zonos_tpu/models/transformer.py``).

Pre-LN blocks, GQA attention with paired-dims RoPE, gated-SiLU MLP. Params
keep the JAX layout: every leaf of ``params["layers"]`` carries a leading
``n_layer`` axis, and a Python loop over layers takes the place of the JAX
``lax.scan``.

The decode step (one token, S = 1) runs through the CUDA kernels where they
apply: int8 projections through K1 and int4 projections (the MLP's too)
through K4 (``ops.quant.qeinsum``), attention over the int8 cache through K2
(``ops.cuda_attention``), and the int8 MLP through K3
(``ops.cuda_matmul.fused_mlp_int8``: fc1 and the gate, then fc2). The
prefill stays on torch.matmul.
"""

from __future__ import annotations

import dataclasses

import torch

from zonos_tpu_torch.config import BackboneConfig
from zonos_tpu_torch.ops.attention import (
    causal_prefix_mask, decode_mask, gqa_attention, gqa_attention_quantized,
)
from zonos_tpu_torch.ops.cuda_attention import attn_core_int8
from zonos_tpu_torch.ops.cuda_matmul import MAX_ROWS, fused_mlp_int8
from zonos_tpu_torch.ops.norms import layer_norm
from zonos_tpu_torch.ops.quant import is_quantized, qeinsum
from zonos_tpu_torch.ops.rope import apply_rope, rope_rows


@dataclasses.dataclass
class KVCache:
    """Static-shape KV cache for all layers, updated in place.

    bf16: k, v [L, B, S, Hkv, Dh]. int8 (k_scale / v_scale set): k, v are
    HEAD-MAJOR [L, B, Hkv, S, Dh] int8 with f32 scales [L, B, Hkv, S], so each
    head's [S, Dh] slab is contiguous for the attention read.
    """

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @classmethod
    def create(cls, cfg: BackboneConfig, batch_size: int, max_seqlen: int, dtype=torch.bfloat16,
               quantized: bool = False, device=None) -> "KVCache":
        hkv, dh, L = cfg.attn_cfg.num_heads_kv, cfg.head_dim, cfg.n_layer
        if quantized:
            qshape = (L, batch_size, hkv, max_seqlen, dh)
            sshape = (L, batch_size, hkv, max_seqlen)
            return cls(
                k=torch.zeros(qshape, dtype=torch.int8, device=device),
                v=torch.zeros(qshape, dtype=torch.int8, device=device),
                k_scale=torch.ones(sshape, dtype=torch.float32, device=device),
                v_scale=torch.ones(sshape, dtype=torch.float32, device=device),
            )
        shape = (L, batch_size, max_seqlen, hkv, dh)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def _kv_quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, S, H, D] → (int8 values, f32 scales [B, S, H]), symmetric per (position, head)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def init_transformer_params(generator: torch.Generator, cfg: BackboneConfig, dtype=torch.bfloat16,
                            device=None) -> dict:
    """Random-init params (normal / sqrt(fan_in)) with a leading layer axis on every leaf."""
    d = cfg.d_model
    hq, hkv, dh = cfg.attn_cfg.num_heads, cfg.attn_cfg.num_heads_kv, cfg.head_dim
    f = cfg.attn_mlp_d_intermediate
    L = cfg.n_layer

    def init(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        return (w / fan_in ** 0.5).to(dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    layers = {
        "norm1": {"scale": ones(L, d), "bias": zeros(L, d)},
        "attn": {
            "in_proj": init((L, d, (hq + 2 * hkv) * dh), d),
            "out_proj": init((L, hq * dh, d), hq * dh),
        },
        "norm2": {"scale": ones(L, d), "bias": zeros(L, d)},
        "mlp": {"fc1": init((L, d, 2 * f), d), "fc2": init((L, f, d), f)},
    }
    return {"layers": layers, "norm_f": {"scale": ones(d), "bias": zeros(d)}}


def _layer(tree, li: int):
    """Layer li's slice of a layer-stacked param (plain tensor, quantized dict; None kept)."""
    if isinstance(tree, dict):
        return {k: _layer(v, li) for k, v in tree.items()}
    return None if tree is None else tree[li]


def _decode_mlp(h2: torch.Tensor, mlp_p: dict) -> torch.Tensor | None:
    """The decode step's int8 MLP through K3, or None where K3 does not apply."""
    fc1, fc2 = mlp_p["fc1"], mlp_p["fc2"]
    if h2.shape[1] != 1 or h2.shape[0] > MAX_ROWS or not (is_quantized(fc1) and is_quantized(fc2)):
        return None
    y = fused_mlp_int8(h2[:, 0].contiguous(), fc1["q"], fc1["s"], fc2["q"], fc2["s"])
    return y[:, None, :].to(h2.dtype)


def _attn_block(
    layer_p: dict,
    cfg: BackboneConfig,
    x: torch.Tensor,  # [B, S, D]
    freqs: torch.Tensor,  # [S, Dh//2, 2] or [B, S, Dh//2, 2]
    cache: KVCache | None,
    li: int,
    write_start: int,
    mask: torch.Tensor | None,  # [B, S, attend_len] bool (unused by the K2 decode route)
    attend_len: int,
    decode_args: tuple | None = None,  # (write_index int32 [1], pad [B], gap_start, gap_len) for K2
) -> torch.Tensor:
    """Attention + MLP sub-block of layer li, for prefill (S > 1) and decode (S = 1)."""
    b, s, _ = x.shape
    hq, hkv, dh = cfg.attn_cfg.num_heads, cfg.attn_cfg.num_heads_kv, cfg.head_dim

    h = layer_norm(x, layer_p["norm1"]["scale"], layer_p["norm1"]["bias"], cfg.norm_epsilon)
    qkv = qeinsum("bsd,de->bse", h, layer_p["attn"]["in_proj"])
    q, k, v = torch.split(qkv, [hq * dh, hkv * dh, hkv * dh], dim=-1)
    q = apply_rope(q.reshape(b, s, hq, dh), freqs)
    k = apply_rope(k.reshape(b, s, hkv, dh), freqs)
    v = v.reshape(b, s, hkv, dh)

    # The cache is written IN PLACE: one slot (or the S prefill slots) of
    # layer li, where JAX's functional dynamic_update_slice returns a new
    # buffer. Only the attend_len window is read, as views. Never copy a
    # layer's whole cache: that made the decode cost scale with the cache
    # allocation instead of the attended window.
    end = write_start + s
    if cache is None:
        att = gqa_attention(q, k, v, mask)
    elif cache.quantized:
        kq, ks = _kv_quantize(k)
        vq, vs = _kv_quantize(v)
        cache.k[li, :, :, write_start:end] = kq.transpose(1, 2)
        cache.v[li, :, :, write_start:end] = vq.transpose(1, 2)
        cache.k_scale[li, :, :, write_start:end] = ks.transpose(1, 2)
        cache.v_scale[li, :, :, write_start:end] = vs.transpose(1, 2)
        k_att = cache.k[li, :, :, :attend_len]
        v_att = cache.v[li, :, :, :attend_len]
        ks_att = cache.k_scale[li, :, :, :attend_len]
        vs_att = cache.v_scale[li, :, :, :attend_len]
        if decode_args is not None:
            write_index, pad_amount, gap_start, gap_len = decode_args
            att = attn_core_int8(q.contiguous(), k_att, ks_att, v_att, vs_att, write_index,
                                 pad_amount, gap_start=gap_start, gap_len=gap_len)
        else:
            att = gqa_attention_quantized(q, k_att, ks_att, v_att, vs_att, mask)
    else:
        cache.k[li, :, write_start:end] = k
        cache.v[li, :, write_start:end] = v
        att = gqa_attention(q, cache.k[li, :, :attend_len], cache.v[li, :, :attend_len], mask)
    x = x + qeinsum("bse,ed->bsd", att.reshape(b, s, hq * dh), layer_p["attn"]["out_proj"])

    h2 = layer_norm(x, layer_p["norm2"]["scale"], layer_p["norm2"]["bias"], cfg.norm_epsilon)
    fused = _decode_mlp(h2, layer_p["mlp"])
    if fused is not None:
        return x + fused
    yg = qeinsum("bsd,de->bse", h2, layer_p["mlp"]["fc1"])
    y, gate = torch.chunk(yg, 2, dim=-1)
    return x + qeinsum("bsf,fd->bsd", y * torch.nn.functional.silu(gate), layer_p["mlp"]["fc2"])


def transformer_forward(
    params: dict,
    cfg: BackboneConfig,
    x: torch.Tensor,  # [B, S, D]
    cache: KVCache | None,
    write_start: int,  # cache slot of x[:, 0]
    pad_amount: torch.Tensor,  # [B] int32: invalid leading cache slots
    attend_len: int,  # number of cache slots visible (>= write_start + S)
    pos_offset: torch.Tensor | None = None,  # [B] logical-position offsets
    gap_len: torch.Tensor | None = None,  # [B] dead cache span after the prefill
    gap_start: int = 0,  # where the dead span begins (prefill_len)
) -> tuple[torch.Tensor, KVCache | None]:
    """Run all layers over x, updating the cache in place. Prefill and decode.

    Prefill: write_start 0, attend_len S. Decode: S = 1, write_start t. A short
    span S > 1 with attend_len != S is the multi-token verify: row r sees
    [pad, write_start + r]. With cache None attention runs over x itself.
    Returns (final-normed hidden states [B, S, D], the same cache).
    """
    b, s, _ = x.shape
    steps = torch.arange(s, device=x.device)
    positions = write_start + steps if pos_offset is None else write_start + steps[None, :] - pos_offset[:, None]
    freqs = rope_rows(positions, cfg.head_dim)

    decode_args = None
    if s > 1 and cache is not None and attend_len != s:
        cols = torch.arange(attend_len, device=x.device)[None, None, :]
        rows = steps[None, :, None]
        mask = (cols >= pad_amount[:, None, None]) & (cols <= write_start + rows)
    elif s > 1 or cache is None:
        mask = causal_prefix_mask(s, pad_amount)
    elif cache.quantized:  # K2 masks from these itself
        mask = None
        wi = torch.tensor([write_start], dtype=torch.int32).to(x.device)
        decode_args = (wi, pad_amount.to(torch.int32), gap_start,
                       None if gap_len is None else gap_len.to(torch.int32))
    else:
        mask = decode_mask(attend_len, pad_amount, write_start, gap_start=gap_start, gap_len=gap_len)

    for li in range(cfg.n_layer):
        x = _attn_block(_layer(params["layers"], li), cfg, x, freqs, cache, li, write_start, mask,
                        attend_len if cache is not None else s, decode_args)
    xo = layer_norm(x, params["norm_f"]["scale"], params["norm_f"]["bias"], cfg.norm_epsilon)
    return xo, cache
