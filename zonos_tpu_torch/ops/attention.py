"""GQA attention and its masks (port of ``zonos_tpu/ops/attention.py``).

GQA views queries as [B, Sq, Hkv, G, Dh] against unreplicated K/V. Softmax is
f32 whatever the input dtype; masked scores are set to -1e30 as in JAX. The
score scale is ``scale`` where a caller gives one (a config's
``attention_multiplier``), else 1/sqrt(Dh).
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def sm_scale_f32(dh: int) -> float:
    """1/sqrt(Dh) rounded to f32: the score scale of every attention path and kernel."""
    return float(torch.tensor(1.0 / math.sqrt(dh), dtype=torch.float32))


def gqa_attention(
    q: torch.Tensor,  # [B, Sq, Hq, Dh]
    k: torch.Tensor,  # [B, Sk, Hkv, Dh]
    v: torch.Tensor,  # [B, Sk, Hkv, Dh]
    mask: torch.Tensor | None,  # [B, Sq, Sk] bool, True = attend
    scale: float | None = None,
) -> torch.Tensor:
    """Grouped-query attention → [B, Sq, Hq, Dh] in q.dtype."""
    b, sq, hq, dh = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * (scale or sm_scale_f32(dh))
    if mask is not None:
        scores = torch.where(mask[:, None, None], scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype).float(), v.float()).to(v.dtype)
    return out.reshape(b, sq, hq, dh)


def gqa_attention_quantized(
    q: torch.Tensor,  # [B, Sq, Hq, Dh]
    kq: torch.Tensor,  # [B, Hkv, Sk, Dh] int8 (head-major)
    ks: torch.Tensor,  # [B, Hkv, Sk] f32
    vq: torch.Tensor,  # [B, Hkv, Sk, Dh] int8
    vs: torch.Tensor,  # [B, Hkv, Sk] f32
    mask: torch.Tensor | None,
    use_qq: bool | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """GQA directly on the int8 KV cache: K's scale multiplies the scores after
    the q·k contraction, V's scale folds into the weights before the PV sum.

    ``use_qq`` (default: on for B >= 16, as in JAX) quantizes q per (batch,
    KV head) and contracts int8 x int8. The integer products are computed in
    f32, where they are exact: |q|, |k| <= 127 and Dh <= 1024 keep every sum
    below 2**24.
    """
    b, sq, hq, dh = q.shape
    hkv = kq.shape[1]
    g = hq // hkv
    scale = scale or sm_scale_f32(dh)
    qg = q.reshape(b, sq, hkv, g, dh)
    if use_qq is None:
        use_qq = b >= 16
    if use_qq:
        qf = qg.float()
        qs = qf.abs().amax(dim=(1, 3, 4), keepdim=True) / 127.0 + 1e-12  # [B, 1, Hkv, 1, 1]
        qq = torch.round(qf / qs)
        scores = torch.einsum("bqhgd,bhkd->bhgqk", qq, kq.float())
        scores = scores * qs.reshape(b, 1, hkv, 1, 1).transpose(1, 2) * ks[:, :, None, None, :] * scale
    else:
        scores = torch.einsum("bqhgd,bhkd->bhgqk", qg.float(), kq.float())
        scores = scores * ks[:, :, None, None, :] * scale
    if mask is not None:
        scores = torch.where(mask[:, None, None], scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    pw = (probs * vs[:, :, None, None, :]).to(q.dtype)
    out = torch.einsum("bhgqk,bhkd->bqhgd", pw.float(), vq.float()).to(q.dtype)
    return out.reshape(b, sq, hq, dh)


def causal_prefix_mask(seq_len: int, pad_amount: torch.Tensor) -> torch.Tensor:
    """bool [B, S, S]: causal, and left-padding columns hidden."""
    idx = torch.arange(seq_len, device=pad_amount.device)
    rows = idx[None, :, None]
    cols = idx[None, None, :]
    return (cols <= rows) & (cols >= pad_amount[:, None, None])


def decode_mask(
    cache_len: int,
    pad_amount: torch.Tensor,
    write_index: int | torch.Tensor,
    gap_start: int | None = None,
    gap_len: torch.Tensor | None = None,
) -> torch.Tensor:
    """bool [B, 1, cache_len]: valid slots are [pad_amount, write_index], minus a
    per-sample dead span [gap_start, gap_start + gap_len) when gap_len is given."""
    cols = torch.arange(cache_len, device=pad_amount.device)[None, None, :]
    m = (cols >= pad_amount[:, None, None]) & (cols <= write_index)
    if gap_len is not None:
        m &= ~((cols >= gap_start) & (cols < gap_start + gap_len[:, None, None]))
    return m

