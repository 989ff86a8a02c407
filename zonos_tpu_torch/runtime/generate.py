"""Autoregressive generation: prefill + decode loop (port of ``zonos_tpu/runtime/generate.py``).

JAX runs prefill → first sample → ``lax.while_loop`` inside one jit. The
port runs the same steps eagerly: the prefill, then a Python loop of decode
steps (``runtime/streaming.build_segment_fn``) that reads one flag back per
step for its stop condition. The bucketing of the prefill, the delayed-code
buffer and the cache is the JAX package's, so cache shapes match.

EOS semantics are the reference's: EOS in codebook 0 caps the remaining
steps at n_q and drains an EOS/MASK staircase down the delayed codebooks,
per sample.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from zonos_tpu_torch import resolve_device
from zonos_tpu_torch.config import ZonosConfig
from zonos_tpu_torch.models.backbone import backbone_forward
from zonos_tpu_torch.ops.cuda_matmul import MAX_ROWS, int8_matmul
from zonos_tpu_torch.ops.delay_pattern import apply_delay_pattern_np, revert_delay_pattern_np
from zonos_tpu_torch.ops.quant import is_quantized
from zonos_tpu_torch.ops.sampling import SamplingParams

UNKNOWN_TOKEN = -1
MAX_REP_WINDOW = 100  # repetition-penalty context cap (the reference's 100-token window)
PREFILL_BUCKET = 64  # default: the prefill is left-padded to a multiple of this
AUDIO_BUCKET = 512  # default: the delayed-code buffer is a multiple of this


def _bucket(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


# ---------------------------------------------------------------------------
# Embeddings / heads
# ---------------------------------------------------------------------------

def embed_codes(embeddings: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Sum of per-codebook embeddings: embeddings [n_q, V, D], codes [B, n_q, S] → [B, S, D]."""
    n_q, vocab, d = embeddings.shape
    codes = codes.long().clamp(0, vocab - 1)
    idx = codes + (torch.arange(n_q, device=codes.device) * vocab)[None, :, None]
    emb = embeddings.reshape(n_q * vocab, d)[idx]  # [B, n_q, S, D]
    return emb.sum(dim=1)


def apply_heads(head_weight, hidden: torch.Tensor, n_q: int) -> torch.Tensor:
    """Fused output heads → f32 logits [B, n_q, S, Vh].

    head_weight is [D, n_q * Vh] or its int8 {"q","s"} dict. A decode-shaped
    call on int8 heads (S = 1, B <= 16) runs through K1, which reads the int8
    weight once and sums in f32 — the product JAX computes with f32
    accumulation; other shapes dequantize at the product.
    """
    b, s, _ = hidden.shape
    if is_quantized(head_weight):
        q, sc = head_weight["q"], head_weight["s"]
        if s == 1 and b <= MAX_ROWS:
            logits = int8_matmul(hidden[:, 0].contiguous(), q, sc)[:, None, :]
        else:
            logits = torch.matmul(hidden.float(), q.float()) * sc.reshape(1, 1, -1)
    else:
        logits = torch.matmul(hidden.float(), head_weight.float())
    vh = logits.shape[-1] // n_q
    return logits.reshape(b, s, n_q, vh).permute(0, 2, 1, 3)


# ---------------------------------------------------------------------------
# Generation state
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DecodeCarry:
    delayed_codes: torch.Tensor  # [B, n_q, S_delayed] int32, written in place
    offset: int  # frame index written next
    cache: object  # KVCache, batch axis 2B (cond ++ uncond)
    stopping: torch.Tensor  # [B] bool
    remaining_steps: torch.Tensor  # [B] int32
    stop_offset: torch.Tensor  # [B] int32: offset of the sample's last drained frame, -1 if none
    steps_done: int
    generators: list  # one torch.Generator per sample row


@dataclasses.dataclass(frozen=True)
class GenerateStatics:
    """Shape and sampling settings of one generate call (JAX's jit statics)."""

    cfg: ZonosConfig
    sampling: SamplingParams
    prefill_len: int  # bucketed Lc + Lp + 1
    delayed_len: int  # bucketed audio_seq_len + n_q
    cache_len: int
    batch_size: int
    forbid_eos: bool = False
    kv_int8: bool = False


def _decode_logits(params, statics: GenerateStatics, x_tokens, cache, write_index: int, pad_amount,
                   cfg_scale: float):
    """One backbone step with CFG batch doubling → guided logits [B, n_q, Vh]."""
    cfg = statics.cfg
    x = embed_codes(params["embeddings"], x_tokens)  # [B, 1, D]
    x = torch.cat([x, x], dim=0)
    h, cache = backbone_forward(
        params["backbone"], cfg.backbone, x, cache,
        write_start=write_index, pad_amount=pad_amount, attend_len=statics.cache_len,
    )
    logits = apply_heads(params["heads"], h, cfg.codebook_dimension)[:, :, 0]
    cond, uncond = torch.chunk(logits, 2, dim=0)
    return uncond + (cond - uncond) * cfg_scale, cache


def _context_slice(delayed: torch.Tensor, offset: int, window: int):
    """Last ``window`` delayed positions before ``offset``, end-aligned; positions
    before 0 clip to index 0 and fall outside the valid count."""
    idx = torch.clamp(offset - window + torch.arange(window, device=delayed.device), 0, delayed.shape[-1] - 1)
    return delayed[:, :, idx], min(offset, window)


def _write_frame(delayed: torch.Tensor, offset: int, next_token: torch.Tensor) -> torch.Tensor:
    """Write next_token into frame ``offset`` where the slot is UNKNOWN (keeps
    audio-prefix frames). In place; returns ``delayed``."""
    cur = delayed[:, :, offset]
    delayed[:, :, offset] = torch.where(cur == UNKNOWN_TOKEN, next_token.to(cur.dtype), cur)
    return delayed


def row_generators(seed, batch_size: int, device) -> list:
    """One torch.Generator per sample row, as JAX's ``seed_to_key`` resolves a seed.

    An int (``None``: a random one): row i draws from the stream of
    (seed, i), so batched rows differ. A sequence of ``batch_size`` ints: row
    i draws from (seed[i], 0), the stream row 0 of a solo run at seed[i]
    draws, so a batched request reproduces its solo run. Either way a row's
    tokens depend on its own seed, row and frame, never on its batch-mates.
    """
    if seed is None:
        seed = int(np.random.randint(0, 2**31 - 1))
    if isinstance(seed, (list, tuple, np.ndarray, torch.Tensor)):
        seeds = [int(s) for s in np.asarray(seed).reshape(-1)]
        if len(seeds) != batch_size:
            raise ValueError(f"{len(seeds)} seeds for a batch of {batch_size}: give one int or one seed per row")
        pairs = [(s, 0) for s in seeds]
    else:
        pairs = [(int(seed), i) for i in range(batch_size)]
    gens = []
    for pair in pairs:
        g = torch.Generator(device=device)
        g.manual_seed(int(np.random.SeedSequence(list(pair)).generate_state(1, dtype=np.uint64)[0]))
        gens.append(g)
    return gens


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def pad_conditioning(prefix_conditioning, pad: int, dtype, device) -> torch.Tensor:
    """Left-pad [2B, Lc, D] conditioning to the prefill bucket, on ``device``."""
    if isinstance(prefix_conditioning, torch.Tensor):
        cond = prefix_conditioning.to(device=device, dtype=dtype)
    else:
        cond = torch.as_tensor(np.asarray(prefix_conditioning, np.float32), device=device).to(dtype)
    return torch.nn.functional.pad(cond, (0, 0, pad, 0))


# ---------------------------------------------------------------------------
# Host-side orchestration
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Request:
    """The device-side inputs of one generate call, shared by every request loop."""

    statics: GenerateStatics
    delayed_init: torch.Tensor  # [B, n_q, S_delayed] int32
    cond_padded: torch.Tensor  # [2B, prefill_len - (Lp + 1), D]
    pad_amount: torch.Tensor  # [2B] int32
    generators: list
    prefix_frames: int  # Lp
    max_steps: int


def prepare_request(
    cfg: ZonosConfig,
    prefix_conditioning,
    audio_prefix_codes: np.ndarray | None,
    max_new_tokens: int,
    cfg_scale: float,
    batch_size: int,
    sampling_params: SamplingParams | dict | None,
    seed,
    dtype,
    forbid_eos: bool,
    kv_int8: bool,
    device,
    prefill_bucket: int = PREFILL_BUCKET,
    audio_bucket: int = AUDIO_BUCKET,
) -> Request:
    """Bucket the prefill, the delayed-code buffer and the cache as the JAX
    package does, and place the request's inputs on ``device``."""
    if isinstance(sampling_params, dict):
        sampling_params = SamplingParams(**sampling_params)
    sampling_params = sampling_params or SamplingParams(min_p=0.1)
    if cfg_scale == 1.0:
        raise ValueError("cfg_scale=1 is not supported: the decode loop is CFG-doubled")

    n_q = cfg.codebook_dimension
    lp = 0 if audio_prefix_codes is None else int(audio_prefix_codes.shape[2])
    t0 = int(prefix_conditioning.shape[1]) + lp + 1
    prefill_len = _bucket(t0, prefill_bucket)
    delayed_len = _bucket(lp + max_new_tokens + n_q, audio_bucket)
    cache_len = _bucket(prefill_len + (delayed_len - (lp + 1)) + 1, 128)
    statics = GenerateStatics(
        cfg=cfg, sampling=sampling_params, prefill_len=prefill_len, delayed_len=delayed_len,
        cache_len=cache_len, batch_size=batch_size, forbid_eos=forbid_eos, kv_int8=kv_int8,
    )
    codes = np.full((batch_size, n_q, delayed_len - n_q), UNKNOWN_TOKEN, np.int32)
    if audio_prefix_codes is not None:
        codes[..., :lp] = np.asarray(audio_prefix_codes, np.int32)
    pad = prefill_len - t0
    return Request(
        statics=statics,
        delayed_init=torch.as_tensor(apply_delay_pattern_np(codes, cfg.masked_token_id), device=device),
        cond_padded=pad_conditioning(prefix_conditioning, pad, dtype, device),
        pad_amount=torch.full((2 * batch_size,), pad, dtype=torch.int32, device=device),
        generators=row_generators(seed, batch_size, device),
        prefix_frames=lp,
        max_steps=max_new_tokens + n_q - 2,
    )


def generate(
    params: dict,
    cfg: ZonosConfig,
    prefix_conditioning,  # [2B, Lc, D] (cond ++ uncond), tensor or array
    audio_prefix_codes: np.ndarray | None = None,  # [B, n_q, Lp]
    max_new_tokens: int = 86 * 30,
    cfg_scale: float = 2.0,
    batch_size: int = 1,
    sampling_params: SamplingParams | dict | None = None,
    seed=None,
    prefill_bucket: int = PREFILL_BUCKET,
    audio_bucket: int = AUDIO_BUCKET,
    dtype=torch.bfloat16,
    forbid_eos: bool = False,
    kv_int8: bool = False,
    return_lengths: bool = False,
    device=None,
    stats: dict | None = None,
):
    """Generate sanitized audio codes [B, n_q, L] (numpy int32).

    L is the longest sample's valid length; shorter samples are zero-padded.
    ``return_lengths`` also returns the per-sample lengths [B]. ``seed`` is an
    int, None or one int per row (``row_generators``). The prefill is
    left-padded to a multiple of ``prefill_bucket`` and the code buffer sized
    to one of ``audio_bucket``. ``params`` must live on ``device`` (default:
    the card). A ``stats`` dict receives the prefill and decode-loop seconds
    (each ending in a device sync) and the number of decode steps.
    """
    from zonos_tpu_torch.runtime.streaming import build_prefill_fn, build_segment_fn

    device = resolve_device(device)
    req = prepare_request(cfg, prefix_conditioning, audio_prefix_codes, max_new_tokens, cfg_scale, batch_size,
                          sampling_params, seed, dtype, forbid_eos, kv_int8, device, prefill_bucket, audio_bucket)
    statics = req.statics

    tic = time.perf_counter()
    carry = build_prefill_fn(statics)(params, req.cond_padded, req.delayed_init, req.prefix_frames + 1,
                                      req.pad_amount, cfg_scale, req.generators)
    if stats is not None:
        _sync(device)
        stats["prefill_s"] = time.perf_counter() - tic
        tic = time.perf_counter()
    final, _status, _codes = build_segment_fn(statics)(
        params, carry, req.pad_amount, cfg_scale, max_steps=req.max_steps, segment_end=2**30,
    )
    delayed_out = final.delayed_codes.cpu().numpy()  # the device-to-host copy syncs
    stop_offset = final.stop_offset.cpu().numpy()
    if stats is not None:
        stats["decode_s"] = time.perf_counter() - tic
        stats["decode_steps"] = final.steps_done

    # A drained sample's stop_offset is its last written frame; a sample that
    # ran to exhaustion ends one past the loop's last frame.
    offsets = np.where(stop_offset >= 0, stop_offset, final.offset)
    out, lengths = postprocess_codes_batched(delayed_out, offsets, cfg)
    if return_lengths:
        return out, lengths
    return out


def postprocess_codes_batched(delayed_out: np.ndarray, offsets: np.ndarray, cfg: ZonosConfig):
    """Per-sample revert + trailing-EOS trim + sanitize → (codes [B, n_q, Lmax], lengths [B])."""
    n_q = cfg.codebook_dimension
    out = revert_delay_pattern_np(np.asarray(delayed_out))
    b = out.shape[0]
    lengths = np.zeros((b,), np.int64)
    for i in range(b):
        valid = max(int(offsets[i]) - n_q, 0)
        search_window = min(50, valid // 4)
        for pos in range(max(0, valid - search_window), valid):
            if (out[i, :, pos] == cfg.eos_token_id).sum() >= n_q // 2:
                valid = pos
                break
        lengths[i] = valid

    out = np.where(out > cfg.eos_token_id, 512, out)
    out = np.where(out == cfg.eos_token_id, 0, out)
    lmax = int(lengths.max(initial=0))
    out = np.clip(out[..., :lmax], 0, cfg.eos_token_id - 1).astype(np.int32)
    for i in range(b):
        out[i, :, lengths[i]:] = 0
    return out, lengths


def postprocess_codes(delayed_out: np.ndarray, offset: int, cfg: ZonosConfig) -> np.ndarray:
    """Revert delay, find the trailing EOS boundary, sanitize (batch-global trim, as
    the reference does for B = 1)."""
    n_q = cfg.codebook_dimension
    out = revert_delay_pattern_np(np.asarray(delayed_out))
    valid_length = max(offset - n_q, 0)
    search_window = min(50, valid_length // 4)
    for pos in range(max(0, valid_length - search_window), valid_length):
        if (out[:, :, pos] == cfg.eos_token_id).sum() >= n_q // 2:
            valid_length = pos
            break
    out = np.where(out > cfg.eos_token_id, 512, out)
    out = np.where(out == cfg.eos_token_id, 0, out)
    out = np.clip(out[..., :valid_length], 0, cfg.eos_token_id - 1)
    return out.astype(np.int32)
