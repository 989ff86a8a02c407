"""Prefill and resumable decode segment (port of the first half of
``zonos_tpu/runtime/streaming.py``).

``build_prefill_fn`` runs the CFG-doubled prefill and samples the first
frame; ``build_segment_fn`` decodes until a step bound or until every sample
has drained its EOS staircase. JAX's ``lax.while_loop`` becomes a Python
loop whose condition reads one flag back from the device per step; the
delayed codes and the KV cache are updated in place. ``generate_audio`` /
``generate_stream`` are still to be ported (ROADMAP.md).
"""

from __future__ import annotations

import math

import torch

from zonos_tpu_torch.models.backbone import backbone_forward, create_cache
from zonos_tpu_torch.ops.delay_pattern import revert_delay_pattern
from zonos_tpu_torch.ops.sampling import sample_from_logits
from zonos_tpu_torch.runtime.generate import (
    MAX_REP_WINDOW,
    DecodeCarry,
    GenerateStatics,
    _context_slice,
    _decode_logits,
    _write_frame,
    apply_heads,
    embed_codes,
)


def _make_bias(statics: GenerateStatics, device) -> torch.Tensor:
    """Logit bias [B, n_q, Vh]: EOS only in codebook 0, there at -log 2 (or forbidden)."""
    cfg = statics.cfg
    b, n_q, vh = statics.batch_size, cfg.codebook_dimension, cfg.head_vocab_size
    bias = torch.zeros((b, n_q, vh), dtype=torch.float32, device=device)
    bias[:, 1:, cfg.eos_token_id] = -torch.inf
    if statics.forbid_eos:
        bias[:, 0, cfg.eos_token_id] = -torch.inf
    else:
        bias[:, 0, cfg.eos_token_id] = -math.log(2.0)
    return bias


def build_prefill_fn(statics: GenerateStatics):
    cfg = statics.cfg
    n_q = cfg.codebook_dimension

    def prefill_fn(params, cond_emb, delayed_init, prefix_frames: int, pad_amount, cfg_scale, generators):
        b = statics.batch_size
        n_prefix = statics.prefill_len - cond_emb.shape[1]
        prefix_emb = embed_codes(params["embeddings"], delayed_init[:, :, :n_prefix])
        prefix_emb = torch.cat([prefix_emb, prefix_emb], dim=0)
        x = torch.cat([cond_emb, prefix_emb], dim=1)

        cache = create_cache(cfg.backbone, 2 * b, statics.cache_len, dtype=cond_emb.dtype,
                             kv_int8=statics.kv_int8, device=cond_emb.device)
        h, cache = backbone_forward(
            params["backbone"], cfg.backbone, x, cache,
            write_start=0, pad_amount=pad_amount, attend_len=statics.prefill_len,
        )
        logits0 = apply_heads(params["heads"], h[:, -1:, :], n_q)[:, :, 0]
        c0, u0 = torch.chunk(logits0, 2, dim=0)
        logits0 = u0 + (c0 - u0) * cfg_scale

        next_token = sample_from_logits(logits0, statics.sampling, generators=generators)
        delayed = _write_frame(delayed_init.clone(), prefix_frames, next_token)
        dev = cond_emb.device
        return DecodeCarry(
            delayed_codes=delayed,
            offset=prefix_frames + 1,
            cache=cache,
            stopping=torch.zeros((b,), dtype=torch.bool, device=dev),
            remaining_steps=torch.full((b,), statics.delayed_len, dtype=torch.int32, device=dev),
            stop_offset=torch.full((b,), -1, dtype=torch.int32, device=dev),
            steps_done=0,
            generators=generators,
        )

    return prefill_fn


def _eos_trim_lengths(out_raw: torch.Tensor, offsets: torch.Tensor, cfg) -> torch.Tensor:
    """Per-sample trailing-EOS boundary vote on the device: valid length is
    offset - n_q, cut to the first position in the last min(50, valid // 4)
    frames where at least n_q // 2 codebooks hold EOS."""
    n_q = cfg.codebook_dimension
    s = out_raw.shape[-1]
    valid = torch.clamp(offsets - n_q, min=0)
    votes = (out_raw == cfg.eos_token_id).sum(dim=1) >= (n_q // 2)  # [B, S]
    pos = torch.arange(s, device=out_raw.device)[None, :]
    window = torch.clamp(valid // 4, max=50)
    in_win = (pos >= (valid - window)[:, None]) & (pos < valid[:, None])
    first = torch.where(votes & in_win, pos, torch.full_like(pos, s)).amin(dim=1)
    return torch.where(first < s, first, valid)


def build_segment_fn(statics: GenerateStatics):
    """Decode until min(segment_end, max_steps) steps or EOS-drain exhaustion."""
    cfg = statics.cfg
    n_q = cfg.codebook_dimension
    window = min(statics.sampling.repetition_penalty_window, MAX_REP_WINDOW)
    use_rep = window > 0 and statics.sampling.repetition_penalty != 1.0

    def segment_fn(params, c: DecodeCarry, pad_amount, cfg_scale, max_steps: int, segment_end: int):
        dev = c.delayed_codes.device
        bias = _make_bias(statics, dev)
        cb = torch.arange(n_q, device=dev)[None, :]
        while (c.offset < statics.delayed_len and c.steps_done < max_steps
               and c.steps_done < segment_end and bool((c.remaining_steps > 0).any())):
            input_frame = c.delayed_codes[:, :, c.offset - 1:c.offset]
            logits, c.cache = _decode_logits(
                params, statics, input_frame, c.cache, statics.prefill_len + c.steps_done, pad_amount, cfg_scale,
            )
            logits = logits + bias
            ctx = valid = None
            if use_rep:
                ctx, valid = _context_slice(c.delayed_codes, c.offset, window)
            next_token = sample_from_logits(
                logits, statics.sampling, generators=c.generators,
                generated_tokens=ctx, generated_valid_len=valid,
            )

            eos_in_cb0 = next_token[:, 0] == cfg.eos_token_id
            remaining = torch.where(eos_in_cb0, torch.clamp(c.remaining_steps, max=n_q), c.remaining_steps)
            c.stopping = c.stopping | eos_in_cb0
            eos_idx = torch.clamp(n_q - remaining, max=n_q - 1)[:, None]
            stop_b = c.stopping[:, None]
            next_token = torch.where(
                stop_b & (cb < eos_idx), cfg.masked_token_id,
                torch.where(stop_b & (cb == eos_idx), cfg.eos_token_id, next_token),
            ).to(torch.int32)
            _write_frame(c.delayed_codes, c.offset, next_token)
            just_drained = (remaining - 1 == 0) & (c.stop_offset < 0)
            c.stop_offset = torch.where(just_drained, c.offset, c.stop_offset).to(torch.int32)
            c.remaining_steps = remaining - 1
            c.offset += 1
            c.steps_done += 1

        # Status [offset, steps_done, all_stopped, lengths[B], drained[B]] and
        # the sanitized de-delayed codes, as the JAX segment returns them.
        all_stopped = bool((c.remaining_steps <= 0).all())
        out = revert_delay_pattern(c.delayed_codes)
        drained = c.stop_offset >= 0
        offsets = torch.where(drained, c.stop_offset, c.offset)
        lengths = _eos_trim_lengths(out, offsets, cfg).to(torch.int32)
        head = torch.tensor([c.offset, c.steps_done, int(all_stopped)], dtype=torch.int32, device=dev)
        status = torch.cat([head, lengths, drained.to(torch.int32)])
        out = torch.where(out > cfg.eos_token_id, 512, out)
        out = torch.where(out == cfg.eos_token_id, 0, out)
        return c, status, torch.clamp(out, 0, cfg.eos_token_id - 1)

    return segment_fn
