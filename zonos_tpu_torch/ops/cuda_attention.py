"""Decode attention kernel K2 (port of ``zonos_tpu/ops/pallas_attention.py``).

``attn_core_int8`` (``csrc/attn_core_int8.cu``) replaces the Pallas
``attn_core_int8``: one query token per row against the head-major int8 KV
cache, valid slots ``[pad[b], write_index]``, and — unlike the Pallas kernel —
the per-sample dead span ``[gap_start, gap_start + gap_len[b])`` of
continuous batching, so no gap case falls back to another path.

The kernel is one launch per call: one thread-block cluster per (b, KV head)
(``attn_plan``), no workspace, nothing allocated but the output. The wrapper
takes the plain PyTorch version for CPU tensors, and only there; for CUDA
tensors it launches the kernel or raises. ``write_index`` is a device int32
tensor, so the launch needs no host value of it. The kernel is built for
head dims 128 (Zonos-v0.1) and 64 (granite-4.0-h-micro's, up to 4 query
heads per KV head) and dispatches on q's last dim; the score scale is
``sm_scale`` where the caller gives one, else 1/sqrt(Dh).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from zonos_tpu_torch.ops import _build
from zonos_tpu_torch.ops.attention import decode_mask, gqa_attention_quantized, sm_scale_f32

HEAD_DIM = 128  # the default DH of csrc/attn_core_int8.cu
MAX_GROUP = {128: 8, 64: 4}  # the DH instantiations and their query heads per KV head
CLUSTER = 16  # blocks per (b, KV head): non-portable; it measured faster than 8 on an H100
MAX_CLUSTER = 16  # MAX_CLUSTER: the non-portable limit the kernel allows
STAGE_SLOTS = 384  # most cache slots of K (and of V) one bulk copy stages
HEAD_BYTES = 2048  # HEAD_BYTES: barriers and per-head scalars
MAX_SMEM_BYTES = 232_448  # 227 KB, what one block may use on an H100


@dataclasses.dataclass(frozen=True)
class AttnPlan:
    cluster: int  # blocks of one cluster, one cluster per (b, KV head)
    share_cap: int  # most slots one rank takes: ceil(S / cluster)
    stage: int  # slots per bulk copy
    smem_bytes: int  # dynamic shared memory per block


@functools.cache
def attn_plan(s: int, g: int, dh: int = HEAD_DIM) -> AttnPlan:
    """K2's launch geometry for a cache of ``s`` slots, ``g`` query heads per
    KV head and heads of ``dh``.

    Shared memory, in the kernel's order: HEAD_BYTES, a K and a V stage of
    ``stage`` rows of dh bytes, the scores [g, share_cap] f32, the two scale
    rows [share_cap] f32, the partial output [g, dh] f32 and the ranks'
    partials of this rank's slice [cluster, ceil(g * dh / cluster)] f32.
    """
    share_cap = max(1, math.ceil(s / CLUSTER))
    stage = min(share_cap, STAGE_SLOTS)
    recv = CLUSTER * math.ceil(g * dh / CLUSTER)
    smem = HEAD_BYTES + 2 * stage * dh + 4 * (g * share_cap + 2 * share_cap + g * dh + recv)
    return AttnPlan(CLUSTER, share_cap, stage, smem)


def attn_shares(lo: int, hi: int, cluster: int) -> list[tuple[int, int]]:
    """(first slot, slot count) of each rank over the valid window [lo, hi):
    the split the kernel computes on the card from pad and write_index."""
    share = -(-(hi - lo) // cluster) if hi > lo else 0
    return [(lo + r * share, max(0, min(hi, lo + r * share + share) - (lo + r * share))) for r in range(cluster)]


def attn_stages(n: int, stage: int) -> list[tuple[int, int]]:
    """(first slot, slot count) of each bulk-copy stage of a rank's n slots."""
    return [(j0, min(stage, n - j0)) for j0 in range(0, n, stage)]


def attn_core_int8_plain(q, kq, ks, vq, vs, write_index, pad_amount, gap_start=0, gap_len=None, sm_scale=None):
    """The masked softmax attention the kernel computes, in q's dtype (no int8 q)."""
    mask = decode_mask(kq.shape[2], pad_amount, write_index, gap_start=gap_start, gap_len=gap_len)
    return gqa_attention_quantized(q, kq, ks, vq, vs, mask, use_qq=False, scale=sm_scale)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"attn_core_int8: {msg}")


def attn_core_int8(
    q: torch.Tensor,  # [B, 1, Hq, Dh] bf16, post-RoPE
    kq: torch.Tensor,  # [B, Hkv, S, Dh] int8 (rows contiguous; batch/head strides free)
    ks: torch.Tensor,  # [B, Hkv, S] f32
    vq: torch.Tensor,  # [B, Hkv, S, Dh] int8, same strides as kq
    vs: torch.Tensor,  # [B, Hkv, S] f32, same strides as ks
    write_index: torch.Tensor,  # int32 [1]: last valid cache slot
    pad_amount: torch.Tensor,  # [B] int32
    gap_start: int = 0,
    gap_len: torch.Tensor | None = None,  # [B] int32 or None
    sm_scale: float | None = None,  # None: 1/sqrt(Dh)
) -> torch.Tensor:
    """Decode attention against the int8 cache → [B, 1, Hq, Dh] in q.dtype."""
    if q.device.type == "cpu":
        return attn_core_int8_plain(q, kq, ks, vq, vs, write_index, pad_amount, gap_start, gap_len, sm_scale)
    b, sq, hq, dh = q.shape
    _, hkv, s, _ = kq.shape
    _require(q.is_cuda and q.dtype == torch.bfloat16 and q.is_contiguous(), "q must be contiguous CUDA bf16")
    _require(sq == 1 and dh in MAX_GROUP, f"q must be [B, 1, Hq, Dh] with Dh in {tuple(MAX_GROUP)}, got {tuple(q.shape)}")
    _require(hq % hkv == 0 and hq // hkv <= MAX_GROUP[dh], f"Hq/Hkv must be an integer <= {MAX_GROUP[dh]} at Dh {dh}")
    for name, t in (("kq", kq), ("vq", vq)):
        _require(t.is_cuda and t.dtype == torch.int8 and tuple(t.shape) == (b, hkv, s, dh), f"{name} must be CUDA int8 [B, Hkv, S, Dh]")
        _require(t.stride(3) == 1 and t.stride(2) == dh and t.stride()[:2] == kq.stride()[:2], f"{name}: rows must be contiguous, strides equal")
    for name, t in (("ks", ks), ("vs", vs)):
        _require(t.is_cuda and t.dtype == torch.float32 and tuple(t.shape) == (b, hkv, s), f"{name} must be CUDA f32 [B, Hkv, S]")
        _require(t.stride(2) == 1 and t.stride()[:2] == ks.stride()[:2], f"{name}: slots must be contiguous, strides equal")
    _require(write_index.is_cuda and write_index.dtype == torch.int32 and write_index.numel() == 1, "write_index must be a CUDA int32 tensor of one element")
    _require(pad_amount.is_cuda and pad_amount.dtype == torch.int32 and pad_amount.shape == (b,) and pad_amount.is_contiguous(), "pad_amount must be CUDA int32 [B]")
    if gap_len is not None:
        _require(gap_len.is_cuda and gap_len.dtype == torch.int32 and gap_len.shape == (b,) and gap_len.is_contiguous(), "gap_len must be CUDA int32 [B]")

    plan = attn_plan(s, hq // hkv, dh)
    _require(plan.smem_bytes <= MAX_SMEM_BYTES, f"a cache of {s} slots needs {plan.smem_bytes} bytes of shared memory")
    _require(kq.data_ptr() % 16 == 0 and vq.data_ptr() % 16 == 0 and kq.stride(0) % 16 == 0 and kq.stride(1) % 16 == 0,
             "kq/vq: base and strides must be multiples of 16 bytes (bulk copies)")
    out = torch.empty((b, 1, hq, dh), dtype=torch.bfloat16, device=q.device)
    gap_ptr = ctypes.c_void_p(gap_len.data_ptr() if gap_len is not None else 0)
    err = _lib().zt_attn_core_int8(
        ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(kq.data_ptr()), ctypes.c_void_p(ks.data_ptr()),
        ctypes.c_void_p(vq.data_ptr()), ctypes.c_void_p(vs.data_ptr()),
        kq.stride(0), kq.stride(1), ks.stride(0), ks.stride(1),
        ctypes.c_void_p(write_index.data_ptr()), ctypes.c_void_p(pad_amount.data_ptr()), gap_ptr,
        int(gap_start), ctypes.c_void_p(out.data_ptr()), b, hkv, hq // hkv, s, plan.cluster, plan.share_cap,
        plan.stage, plan.smem_bytes, dh, sm_scale or sm_scale_f32(dh),
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
    )
    _build.check(err, "attn_core_int8")
    _build.count_launch(attn_core_int8)
    return out


attn_core_int8.launches = 0

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    lib = _build.load("attn_core_int8")
    lib.zt_attn_core_int8.argtypes = [_P, _P, _P, _P, _P, _L, _L, _L, _L, _P, _P, _P, _I, _P,
                                      _I, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P]
    lib.zt_attn_core_int8.restype = _I
    return lib
