"""Prefill, resumable decode segment and the segmented request loops (port of
``zonos_tpu/runtime/streaming.py``).

``build_prefill_fn`` runs the CFG-doubled prefill and samples the first
frame; ``build_segment_fn`` decodes until a step bound or until every sample
has drained its EOS staircase. JAX's ``lax.while_loop`` becomes a Python
loop whose condition reads one flag back from the device per step; the
delayed codes and the KV cache are updated in place.

``generate_stream`` yields audio (or, without a codec, codes) segment by
segment; ``generate_audio`` is the full-request path with the DAC of settled
code spans interleaved with the decode segments and one PCM readback.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from zonos_tpu_torch import resolve_device
from zonos_tpu_torch.models.backbone import backbone_forward, create_cache
from zonos_tpu_torch.ops.delay_pattern import revert_delay_pattern
from zonos_tpu_torch.ops.sampling import SamplingParams, sample_from_logits
from zonos_tpu_torch.runtime.generate import (
    AUDIO_BUCKET,
    MAX_REP_WINDOW,
    PREFILL_BUCKET,
    DecodeCarry,
    GenerateStatics,
    _bucket,
    _context_slice,
    _decode_logits,
    _sync,
    _write_frame,
    apply_heads,
    embed_codes,
    postprocess_codes_batched,
    prepare_request,
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


# Default frames of left context each streamed chunk is decoded with (then trimmed).
STREAM_CONTEXT_FRAMES = 16


def _read_status(status: torch.Tensor, batch_size: int):
    """(offset, steps, all_stopped, lengths [B], drained [B]) from a segment's status vector."""
    sv = status.cpu().numpy()  # one small readback per segment
    offset, steps, all_stopped = (int(v) for v in sv[:3])
    return offset, steps, bool(all_stopped), sv[3:3 + batch_size].astype(np.int64), sv[3 + batch_size:].astype(bool)


def generate_stream(
    params: dict,
    cfg,
    prefix_conditioning,  # [2B, Lc, D]
    autoencoder=None,
    audio_prefix_codes: np.ndarray | None = None,
    max_new_tokens: int = 86 * 30,
    cfg_scale: float = 2.0,
    batch_size: int = 1,
    sampling_params: SamplingParams | dict | None = None,
    seed=None,
    first_chunk_frames: int = 16,
    chunk_frames: int = 64,
    dac_context_frames: int = STREAM_CONTEXT_FRAMES,
    prefill_bucket: int = PREFILL_BUCKET,
    audio_bucket: int = AUDIO_BUCKET,
    dtype=torch.bfloat16,
    forbid_eos: bool = False,
    kv_int8: bool = False,
    on_progress=None,
    device=None,
):
    """Yield (pcm_chunk [T] float32, sample_rate) as audio becomes available.

    The first segment decodes ``first_chunk_frames`` steps, later ones
    ``chunk_frames``. Each chunk is decoded with ``dac_context_frames`` of
    left context, which is trimmed. The final yield truncates at the EOS
    boundary exactly like ``generate``.

    batch_size > 1 with an autoencoder is BATCHED streaming: each yield is
    ((pcm [B, T], lengths [B], final [B]), sr), all samples' chunks decoded in
    one codec call. ``lengths[i]`` is sample i's valid frame count as known
    so far, exact where ``final[i]`` (its EOS drain completed, or the stream
    ended); every chunk zeroes each sample's PCM past its own boundary.

    Without an autoencoder the stream yields (None, sr) per segment and the
    final sanitized codes [B, n_q, L] last; ``on_progress(steps)`` is called
    between segments and may return False to stop early.
    """
    device = resolve_device(device)
    req = prepare_request(cfg, prefix_conditioning, audio_prefix_codes, max_new_tokens, cfg_scale, batch_size,
                          sampling_params, seed, dtype, forbid_eos, kv_int8, device, prefill_bucket, audio_bucket)
    statics = req.statics
    segment = build_segment_fn(statics)
    n_q = cfg.codebook_dimension
    hop = autoencoder.config.hop_length if autoencoder is not None else 512
    sr = autoencoder.sampling_rate if autoencoder is not None else 44100

    carry = build_prefill_fn(statics)(params, req.cond_padded, req.delayed_init, req.prefix_frames + 1,
                                      req.pad_amount, cfg_scale, req.generators)
    emitted_frames = req.prefix_frames  # de-delayed frames already emitted as audio
    segment_end = first_chunk_frames
    while True:
        carry, status, device_codes = segment(params, carry, req.pad_amount, cfg_scale, req.max_steps, segment_end)
        offset, steps, all_stopped, seg_lengths, seg_drained = _read_status(status, batch_size)
        done = offset >= statics.delayed_len or steps >= req.max_steps or all_stopped
        if on_progress is not None and not done and on_progress(steps) is False:
            done = True  # abort requested: emit what exists and stop

        if done:
            if autoencoder is not None:
                # PCM mode: per-sample lengths from the device-side EOS vote.
                out_codes, lengths_final = None, seg_lengths
                total = int(lengths_final.max(initial=0))
            else:
                # Codes mode: one readback and the host postprocess.
                stop_off = carry.stop_offset.cpu().numpy()
                offsets = np.where(stop_off >= 0, stop_off, offset)
                out_codes, lengths_final = postprocess_codes_batched(carry.delayed_codes.cpu().numpy(), offsets, cfg)
                total = out_codes.shape[-1]
        else:
            out_codes, lengths_final = None, None
            total = max(offset - n_q, 0)  # complete de-delayed frames so far

        if autoencoder is not None and total > emitted_frames:
            ctx = min(dac_context_frames, emitted_frames)
            take = min(total, int(device_codes.shape[2]))
            lo = emitted_frames - ctx
            n = take - lo
            # The slice length is bucketed like the JAX package's (the final
            # chunk's raw span varies with the EOS position); the overshoot is
            # zeroed, as the codec's own padding would be.
            bucket = max(int(getattr(autoencoder, "frame_bucket", 1) or 1), 1)
            n_pad = min(_bucket(n, bucket), int(device_codes.shape[2]) - lo)
            chunk_codes = device_codes[:, :, lo:lo + n_pad]
            if n_pad > n:
                chunk_codes = torch.where(torch.arange(n_pad, device=device)[None, None, :] >= n, 0, chunk_codes)
            wav = autoencoder.decode(chunk_codes)  # [B, 1, n_pad * hop]
            if batch_size == 1:
                yield wav[0, 0, ctx * hop:n * hop], sr
            else:
                pcm = np.array(wav[:, 0, ctx * hop:n * hop])
                if done:
                    lengths = np.asarray(lengths_final, np.int64)
                    final = np.ones((batch_size,), bool)
                else:
                    lengths = np.where(seg_drained, seg_lengths, total).astype(np.int64)
                    final = seg_drained
                for i in range(batch_size):
                    pcm[i, max(int(lengths[i]) - emitted_frames, 0) * hop:] = 0.0
                yield (pcm, lengths, final), sr
            emitted_frames = total
        elif autoencoder is not None and batch_size > 1 and done:
            # No new frames in the last segment: still deliver the final lengths.
            yield (np.zeros((batch_size, 0), np.float32), np.asarray(lengths_final, np.int64),
                   np.ones((batch_size,), bool)), sr
        elif autoencoder is None and (done or total > emitted_frames):
            yield (out_codes if done else None), sr
            emitted_frames = total

        if done:
            return
        segment_end = steps + chunk_frames


# The DAC decoder's receptive field on the flagship geometry (upsampling
# 8/8/4/2, kernel-7 residual units at dilations 1/3/9): an exact interior
# reconstruction needs at least 20 frames of context on each side.
_DAC_RF_FRAMES = 24
# Right margin before a span is settled: a piece [a, b) reads codes up to
# b + RF, and none of them may change later, neither by generation nor by an
# EOS boundary found later (which lies >= total - 50: n_q drain steps plus the
# trailing-EOS vote window). Margin >= 50 + RF; 96 leaves headroom.
_SETTLE_MARGIN = 96
# Decode steps per segment when the caller gives none: the JAX package's
# value for a device on a local link, which the card always is.
LOCAL_CHUNK_FRAMES = 256


def generate_audio(
    params: dict,
    cfg,
    prefix_conditioning,  # [2B, Lc, D]
    autoencoder,
    audio_prefix_codes: np.ndarray | None = None,
    max_new_tokens: int = 86 * 30,
    cfg_scale: float = 2.0,
    batch_size: int = 1,
    sampling_params: SamplingParams | dict | None = None,
    seed=None,
    chunk_frames: int | None = None,
    prefill_bucket: int = PREFILL_BUCKET,
    audio_bucket: int = AUDIO_BUCKET,
    dtype=torch.bfloat16,
    forbid_eos: bool = False,
    kv_int8: bool = False,
    pcm_int16: bool = False,
    device=None,
    stats: dict | None = None,
):
    """Full request → (wav [B, Lmax * hop] float32, lengths [B] int64); with
    ``pcm_int16`` the wav is int16, quantized on the device.

    The decode loop runs in segments of ``chunk_frames`` steps (default
    ``LOCAL_CHUNK_FRAMES``). After each segment every span of codes that no
    future frame can change is handed to the DAC, with ``_DAC_RF_FRAMES`` of
    context on both sides and each sample's codes zeroed past its own known
    EOS boundary; the final piece ends at the stream end with a bucket-aligned
    start, so its padding matches a whole-request decode. The PCM pieces stay
    on the device and come back in one readback. Tokens and lengths equal
    ``generate`` at the same seed; the PCM equals ``generate`` +
    ``autoencoder.decode`` up to the convolutions' summation order, which
    varies with the piece shape.

    ``seed``, ``prefill_bucket`` and ``audio_bucket`` are ``generate``'s.
    A ``stats`` dict receives ``prefill_s``, ``segments_s`` (the decode
    segments, each ending in its status readback, so DAC work queued behind a
    segment is counted there), ``dac_s`` (host time issuing the DAC pieces and
    the final readback), ``decode_steps`` and ``pieces``.
    """
    device = resolve_device(device)
    if chunk_frames is None:
        chunk_frames = LOCAL_CHUNK_FRAMES
    req = prepare_request(cfg, prefix_conditioning, audio_prefix_codes, max_new_tokens, cfg_scale, batch_size,
                          sampling_params, seed, dtype, forbid_eos, kv_int8, device, prefill_bucket, audio_bucket)
    statics = req.statics
    segment = build_segment_fn(statics)
    n_q = cfg.codebook_dimension
    hop = autoencoder.config.hop_length
    bucket = max(int(getattr(autoencoder, "frame_bucket", 1) or 1), 1)
    # Piece starts land on DAC-bucket multiples so the final piece's padded
    # tail matches the whole-request decode's.
    piece_frames = _bucket(max(chunk_frames, _DAC_RF_FRAMES * 2), bucket)
    timing = {"prefill_s": 0.0, "segments_s": 0.0, "dac_s": 0.0}

    def dac_piece(device_codes, a: int, b: int, bounds: torch.Tensor, final: bool) -> torch.Tensor:
        """DAC-decode output frames [a, b), each sample masked past its bound."""
        if final:
            lo = max(((a - _DAC_RF_FRAMES) // bucket) * bucket, 0)
            hi = min(lo + _bucket(b - lo, bucket), int(device_codes.shape[2]))
        else:
            lo = max(a - _DAC_RF_FRAMES, 0)
            hi = min(b + _DAC_RF_FRAMES, int(device_codes.shape[2]))
        fidx = lo + torch.arange(hi - lo, device=device)
        piece = torch.where(fidx[None, None, :] < bounds[:, None, None], device_codes[:, :, lo:hi], 0)
        pcm = autoencoder.decode_device(piece, to_int16=pcm_int16)
        return pcm[:, (a - lo) * hop:(b - lo) * hop]

    tic = time.perf_counter()
    carry = build_prefill_fn(statics)(params, req.cond_padded, req.delayed_init, req.prefix_frames + 1,
                                      req.pad_amount, cfg_scale, req.generators)
    if stats is not None:
        _sync(device)
        timing["prefill_s"] = time.perf_counter() - tic
    pieces: list[torch.Tensor] = []  # device PCM, in frame order
    next_start = 0  # first output frame not yet handed to the DAC
    seg_end = chunk_frames
    while True:
        tic = time.perf_counter()
        carry, status, device_codes = segment(params, carry, req.pad_amount, cfg_scale, req.max_steps, seg_end)
        offset, steps, all_stopped, seg_lengths, seg_drained = _read_status(status, batch_size)
        timing["segments_s"] += time.perf_counter() - tic
        tic = time.perf_counter()
        done = offset >= statics.delayed_len or steps >= req.max_steps or all_stopped
        if done:
            lengths = seg_lengths
            final_total = int(lengths.max(initial=0))
            bounds = torch.as_tensor(lengths, dtype=torch.int64, device=device)
            while next_start < final_total:
                b_end = min(next_start + piece_frames, final_total)
                pieces.append(dac_piece(device_codes, next_start, b_end, bounds, final=b_end == final_total))
                next_start = b_end
            break
        bounds = torch.as_tensor(np.where(seg_drained, seg_lengths, 2**31 - 1), dtype=torch.int64, device=device)
        settled = max(offset - n_q - _SETTLE_MARGIN, 0)
        while settled - next_start >= piece_frames:
            pieces.append(dac_piece(device_codes, next_start, next_start + piece_frames, bounds, final=False))
            next_start += piece_frames
        timing["dac_s"] += time.perf_counter() - tic
        seg_end += chunk_frames

    if not pieces:
        wav = np.zeros((batch_size, 0), np.int16 if pcm_int16 else np.float32)
    else:
        wav = torch.cat(pieces, dim=1).cpu().numpy()  # one readback
    timing["dac_s"] += time.perf_counter() - tic
    if stats is not None:
        stats.update(timing, decode_steps=carry.steps_done, pieces=len(pieces))
    return wav, lengths
