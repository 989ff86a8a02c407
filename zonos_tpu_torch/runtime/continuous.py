"""Continuous batching: requests join and leave an in-flight batched decode
(port of ``zonos_tpu/runtime/continuous.py``).

The batch keeps its shapes while its membership changes between segments:

* the decode runs with per-slot ``pos_offset`` / ``gap_len`` ([2B] int32): a
  slot can hold a request whose prefill was written at cache positions
  [0, P) while the batch is already at step j, so RoPE rotates at the
  logical position (physical - j) and the dead span [P, P + j) is masked
  out of its attention (K2 masks it itself);
* ``join`` runs the ordinary prefill at batch size 1 (same statics), then
  copies its cache rows, delayed-code row, flags and generator into a free
  slot between two segments;
* ``kill`` marks a slot drained, to seed a partly filled batch with dummy
  slots and to retire slots;
* ``roll`` compacts the KV timeline (and the delayed-frame timeline) so the
  live entries stay inside a small attention window.

JAX builds pure functions of the carry and donates it. The port changes the
carry in place: the cache rows, delayed codes and flags are written by
kernels queued on the stream after the segment dispatched before them, so
stream order keeps every read of a segment before the next change. The
carry's ``offset`` and ``steps_done`` are host ints in the port, so the
joiner's delayed-row shift ``bc.offset - c1.offset`` is computed on the
host; it is the number JAX computes on the device.

The de-delayed frame timeline stays global: a joiner's audio begins at the
batch's current frame (its delayed row is the fresh prefill row rolled right
so its first sampled frame lands at offset - 1). With deterministic sampling
a joined request produces exactly the tokens of its solo run.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from zonos_tpu_torch.models.hybrid import HybridCache
from zonos_tpu_torch.models.transformer import KVCache
from zonos_tpu_torch.runtime.generate import UNKNOWN_TOKEN, DecodeCarry, GenerateStatics


def _scatter_rows(dst: torch.Tensor, src: torch.Tensor, slot: int, b: int, axis: int) -> None:
    """Copy src's two CFG rows (cond, uncond) into dst rows (slot, B + slot) along ``axis``, in place."""
    dst.select(axis, slot).copy_(src.select(axis, 0))
    dst.select(axis, slot + b).copy_(src.select(axis, 1))


def _set(vec: torch.Tensor, pairs) -> torch.Tensor:
    """A copy of a small per-slot vector with ``vec[i] = v`` for (i, v) in pairs."""
    out = vec.clone()
    for i, v in pairs:
        out[i] = v
    return out


def build_join_fn(statics: GenerateStatics):
    """(batch_carry, carry1, slot, pos_offset, gap_len, pad_amount, new_pad)
    → (batch_carry, pos_offset', gap_len', pad_amount').

    ``carry1`` is the joiner's batch-size-1 prefill carry (same prefill_len
    and cache_len). Its delayed row is rolled by ``bc.offset - c1.offset``
    so that the prefill-written frame lands at the batch's offset - 1, the
    next step's input. The slot's CFG rows (slot, B + slot) get the fresh
    cache rows, the position offset and gap length of the batch's current
    step, and the joiner's own prefill left-pad ``new_pad`` (two ints). The
    joiner's generator takes over the slot's, after the draw its prefill
    made, so its tokens continue its solo stream.
    """
    b = statics.batch_size

    def join_fn(bc: DecodeCarry, c1: DecodeCarry, slot: int, pos_offset, gap_len, pad_amount, new_pad):
        join_step = bc.steps_done
        cache, c1c = bc.cache, c1.cache
        if isinstance(cache, KVCache):  # batch axis 1 on every leaf, bf16 or head-major int8
            leaves = [(cache.k, c1c.k), (cache.v, c1c.v)]
            if cache.quantized:
                leaves += [(cache.k_scale, c1c.k_scale), (cache.v_scale, c1c.v_scale)]
            for dst, src in leaves:
                _scatter_rows(dst, src, slot, b, 1)
        else:  # HybridCache: KV rows on axis 0; the Mamba states (axis 1 under the run axis) join by row copy
            for name, axis in (("kv_k", 0), ("kv_v", 0), ("kv_ks", 0), ("kv_vs", 0), ("conv", 1), ("ssm", 1)):
                for dst, src in zip(getattr(cache, name), getattr(c1c, name)):
                    if dst is not None:
                        _scatter_rows(dst, src, slot, b, axis)
        bc.delayed_codes[slot] = torch.roll(c1.delayed_codes[0], bc.offset - c1.offset, dims=-1)
        bc.stopping[slot] = False
        bc.remaining_steps[slot] = statics.delayed_len
        bc.stop_offset[slot] = -1
        bc.generators[slot] = c1.generators[0]
        pos_offset = _set(pos_offset, [(slot, join_step), (slot + b, join_step)])
        gap_len = _set(gap_len, [(slot, join_step), (slot + b, join_step)])
        pad_amount = _set(pad_amount, [(slot, int(new_pad[0])), (slot + b, int(new_pad[1]))])
        return bc, pos_offset, gap_len, pad_amount

    return join_fn


def build_kill_fn(statics: GenerateStatics):
    """(carry, slot, stop_at) → carry with the slot marked drained.

    ``stop_at`` becomes the slot's stop_offset: 0 for dummy slots (the
    device EOS vote then gives length 0), a frame for a token-budget cap
    (the vote then gives stop_at - n_q, the solo exhaustion rule).
    """

    def kill_fn(bc: DecodeCarry, slot: int, stop_at: int):
        bc.stopping[slot] = True
        bc.remaining_steps[slot] = 0
        bc.stop_offset[slot] = stop_at
        return bc

    return kill_fn


def _roll_tail(x: torch.Tensor, axis: int, p: int, m: int, per: int | None = None) -> None:
    """In place: positions [p, S) along ``axis`` rolled left by m (wrapping).
    torch.roll copies the span first, so the overlapping shift reads no
    written slot. ``per`` rolls one index of that leading axis at a time,
    which bounds the copy to one layer of the cache."""
    if m == 0:
        return
    if per is not None:
        for i in range(x.shape[per]):
            _roll_tail(x.select(per, i), axis - 1, p, m)
        return
    tail = x.narrow(axis, p, x.shape[axis] - p)
    tail.copy_(torch.roll(tail, -m, dims=axis))


def build_roll_fn(statics: GenerateStatics):
    """(carry, m, pos_offset, gap_len, r=None) → (carry, pos_offset', gap_len').

    KV timeline compaction: the decode region [prefill_len, cache_len) of
    every cache row moves left by ``m`` slots, so the live entries stay
    inside a small attention window. Sound when ``m`` is at most every
    active slot's gap_len and at most steps_done; steps_done, pos_offset and
    gap_len drop by m, so every active slot's RoPE positions and dead-span
    mask are unchanged. The garbage the roll wraps to the tail sits past
    every later write index. With ``r``, the delayed-frame timeline drops
    its first r frames too (the engine guarantees they are shipped and out
    of every live window): the codes roll left by r, the vacated tail is
    reset to UNKNOWN, and offset and stop offsets move with them.
    """
    p = statics.prefill_len

    def roll_fn(bc: DecodeCarry, m: int, pos_offset, gap_len, r: int | None = None):
        cache = bc.cache
        if isinstance(cache, KVCache):
            axis = 3 if cache.quantized else 2  # [L, 2B, Hkv, S, Dh] / [L, 2B, S, Hkv, Dh]
            for x in (cache.k, cache.v):
                _roll_tail(x, axis, p, m, per=0)
            if cache.quantized:  # [L, 2B, Hkv, S]
                for x in (cache.k_scale, cache.v_scale):
                    _roll_tail(x, 3, p, m, per=0)
        else:  # HybridCache: only the attention groups' timelines roll
            axis = 2 if cache.quantized else 1  # [2B, Hkv, S, Dh] / [2B, S, Hkv, Dh]
            for x in [*cache.kv_k, *cache.kv_v]:
                if x is not None:
                    _roll_tail(x, axis, p, m)
            for x in [*cache.kv_ks, *cache.kv_vs]:
                if x is not None:
                    _roll_tail(x, 2, p, m)
        if r is not None:
            delayed = torch.roll(bc.delayed_codes, -r, dims=-1)
            pos = torch.arange(delayed.shape[-1], device=delayed.device)
            bc.delayed_codes.copy_(torch.where(pos[None, None, :] >= bc.offset - r, UNKNOWN_TOKEN, delayed))
            bc.offset -= r
            bc.stop_offset = torch.where(bc.stop_offset >= 0, bc.stop_offset - r, bc.stop_offset)
        bc.steps_done -= m
        return bc, pos_offset - m, torch.clamp(gap_len - m, min=0)

    return roll_fn


def build_set_sampling_row_fn():
    """(rt [B], cfg_vec [B], slot, new_rt [1], new_cfg) → (rt', cfg_vec') with
    row ``slot`` replaced: a joiner's sampling parameters and CFG scale."""

    def set_row(rt, cfg_vec, slot: int, new_rt, new_cfg: float):
        return rt.set_row(slot, new_rt), _set(cfg_vec, [(slot, float(new_cfg))])

    return set_row


@functools.lru_cache(maxsize=1)
def compiled_set_sampling_row():
    return build_set_sampling_row_fn()


@functools.lru_cache(maxsize=8)
def compiled_continuous_fns(statics: GenerateStatics):
    """(start, segment, prefill_b1, join, kill) for a continuous batch.

    ``start`` is the prefill followed by a segment (JAX fuses them into one
    dispatch); ``segment`` is the streaming segment, which takes
    ``pos_offset`` / ``gap_len``; ``prefill_b1`` shares every static but the
    batch size. The port compiles nothing: "compiled" keeps JAX's names.
    """
    from zonos_tpu_torch.runtime.streaming import build_prefill_fn, build_segment_fn

    prefill = build_prefill_fn(statics)
    segment = build_segment_fn(statics)

    def start(params, cond_emb, delayed_init, prefix_frames, pad_amount, cfg_scale, generators, max_steps,
              segment_end, rt_params=None):
        carry = prefill(params, cond_emb, delayed_init, prefix_frames, pad_amount, cfg_scale, generators,
                        rt_params=rt_params)
        return segment(params, carry, pad_amount, cfg_scale, max_steps, segment_end, rt_params=rt_params,
                       early_exit=False)

    prefill_b1 = build_prefill_fn(dataclasses.replace(statics, batch_size=1))
    return start, segment, prefill_b1, build_join_fn(statics), build_kill_fn(statics)


@functools.lru_cache(maxsize=8)
def compiled_roll_fn(statics: GenerateStatics):
    return build_roll_fn(statics)


@functools.lru_cache(maxsize=64)
def compiled_segment_attend(statics: GenerateStatics, attend_len: int):
    """The decode segment attending only the first ``attend_len`` cache slots:
    K2 and the masks read a view of the cache cut along S. One per ladder
    rung; the carry (the whole cache allocation) is shared by every rung."""
    from zonos_tpu_torch.runtime.streaming import build_segment_fn

    if attend_len >= statics.cache_len:
        return compiled_continuous_fns(statics)[1]
    return build_segment_fn(dataclasses.replace(statics, attend_len=attend_len))
