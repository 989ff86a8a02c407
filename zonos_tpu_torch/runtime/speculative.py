"""Speculative decode: up to 2 frames per backbone pass (port of
``zonos_tpu/runtime/speculative.py``).

    pass t: backbone([frame_{t-1}, draft_t]) → hidden h0, h1
            sample the true frame_t from heads(h0)
            accepted = (frame_t == draft_t, all codebooks)
            if accepted: sample frame_{t+1} from heads(h1)   → advanced 2
            else:        h1 is void; its KV slot is rewritten next pass
            draft_next = greedy(draft_heads(h of the last valid position))

The draft comes from ``params["draft_heads"]`` (a Medusa-style second head,
the output heads' shape) applied to the same hidden state; without one the
output heads draft for themselves. With greedy sampling the output equals
sequential greedy decoding token for token, for any draft: a rejected draft
is re-sampled from the true logits, an accepted one is the true greedy token.

The verify pass is the backbone's multi-token decode (S = 2 over the cache),
which dequantizes int8 weights at the product, as JAX's does: K1, K2 and K3
take one token. The draft heads run on one position, [2, 1, D], through K1
on int8 heads. The loop reads one flag per pass (accepted or not) and the
stop condition, and computes only the draft it keeps.

Scope, as JAX's: batch size 1, the transformer backbone, no repetition
penalty.
"""

from __future__ import annotations

import numpy as np
import torch

from zonos_tpu_torch import resolve_device
from zonos_tpu_torch.config import ZonosConfig
from zonos_tpu_torch.models.backbone import backbone_forward
from zonos_tpu_torch.ops.delay_pattern import apply_delay_pattern_np
from zonos_tpu_torch.ops.sampling import SamplingParams, sample_from_logits
from zonos_tpu_torch.runtime.generate import (
    UNKNOWN_TOKEN,
    GenerateStatics,
    _bucket,
    _guide,
    apply_heads,
    embed_codes,
    pad_conditioning,
    postprocess_codes_batched,
    row_generators,
)
from zonos_tpu_torch.runtime.streaming import _advance, _make_bias, build_prefill_fn


def check_speculative(statics: GenerateStatics) -> None:
    """The refusals of JAX's ``build_spec_generate_fn``."""
    if statics.batch_size != 1:
        raise AssertionError("speculative decode is single-stream")
    if statics.cfg.backbone.is_hybrid:
        raise AssertionError("speculative decode is transformer-only")
    s = statics.sampling
    if s.repetition_penalty != 1.0 and s.repetition_penalty_window != 0:
        raise AssertionError("speculative decode does not support the repetition penalty")


def spec_decode(params, statics: GenerateStatics, carry, pad_amount, cfg_scale, max_steps: int):
    """Draft-and-verify from a prefill's carry until the step bound, the end of
    the code buffer, or every sample drained. Returns (carry, passes, accepted)."""
    cfg = statics.cfg
    n_q = cfg.codebook_dimension
    heads = params["heads"]
    draft_heads = params.get("draft_heads", heads)
    bias = _make_bias(statics, carry.delayed_codes.device)
    cb = torch.arange(n_q, device=carry.delayed_codes.device)[None, :]

    def draft_from(h):  # [2, 1, D] hidden → greedy frame [1, n_q]
        logits = apply_heads(draft_heads, h, n_q)[:, :, 0]
        return torch.argmax(_guide(logits, cfg_scale) + bias, dim=-1).to(torch.int32)

    # The first draft is the first sampled frame itself: pass 0 verifies it.
    draft = carry.delayed_codes[:, :, carry.offset - 1].clone()
    n_pass = n_accept = 0
    c = carry
    while c.offset < statics.delayed_len and c.steps_done < max_steps and bool((c.remaining_steps > 0).any()):
        pair = torch.cat([c.delayed_codes[:, :, c.offset - 1:c.offset], draft[:, :, None]], dim=2)  # [1, n_q, 2]
        x = embed_codes(params["embeddings"], pair)
        h, c.cache = backbone_forward(params["backbone"], cfg.backbone, torch.cat([x, x], dim=0), c.cache,
                                      write_start=statics.prefill_len + c.steps_done, pad_amount=pad_amount,
                                      attend_len=statics.cache_len)
        guided = _guide(apply_heads(heads, h, n_q), cfg_scale) + bias[:, :, None, :]  # [1, n_q, 2, Vh]
        f = sample_from_logits(guided[:, :, 0], statics.sampling, generators=c.generators)
        f2 = sample_from_logits(guided[:, :, 1], statics.sampling, generators=c.generators)
        # the second frame needs offset + 1 < delayed_len: at the last position a pass only verifies
        accept = bool(torch.equal(f, draft)) and not bool(c.stopping[0]) and c.offset < statics.delayed_len - 1
        _advance(c, f, cfg, cb)
        if accept:
            _advance(c, f2, cfg, cb)
        draft = draft_from(h[:, 1:2] if accept else h[:, 0:1])
        c.steps_done += 1 + int(accept)
        n_pass += 1
        n_accept += int(accept)
    return c, n_pass, n_accept


def generate_speculative(
    params: dict,
    cfg: ZonosConfig,
    prefix_conditioning,  # [2, Lc, D] (cond ++ uncond)
    max_new_tokens: int = 86 * 30,
    cfg_scale: float = 2.0,
    sampling_params: SamplingParams | dict | None = None,
    seed: int | None = None,
    prefill_bucket: int = 64,
    audio_bucket: int = 512,
    dtype=torch.bfloat16,
    forbid_eos: bool = False,
    kv_int8: bool = False,
    return_stats: bool = False,
    device=None,
):
    """Single-stream generate with up to 2 frames per backbone pass.

    The output contract of ``runtime.generate.generate`` (sanitized codes
    [1, n_q, L], numpy int32); with ``return_stats`` also
    {"passes", "accepted", "frames", "acceptance"}. ``params`` must live on
    ``device`` (default: the card)."""
    device = resolve_device(device)
    if isinstance(sampling_params, dict):
        sampling_params = SamplingParams(**sampling_params)
    sampling_params = sampling_params or SamplingParams(min_p=0.1, repetition_penalty=1.0)
    if cfg_scale == 1.0:
        raise AssertionError("cfg_scale=1 is not supported: the decode loop is CFG-doubled")

    n_q = cfg.codebook_dimension
    t0 = int(prefix_conditioning.shape[1]) + 1
    prefill_len = _bucket(t0, prefill_bucket)
    delayed_len = _bucket(max_new_tokens + n_q, audio_bucket)
    statics = GenerateStatics(
        cfg=cfg, sampling=sampling_params, prefill_len=prefill_len, delayed_len=delayed_len,
        cache_len=_bucket(prefill_len + delayed_len + 2, 128), batch_size=1, forbid_eos=forbid_eos,
        kv_int8=kv_int8,
    )
    check_speculative(statics)

    codes = np.full((1, n_q, delayed_len - n_q), UNKNOWN_TOKEN, np.int32)
    delayed_init = torch.as_tensor(apply_delay_pattern_np(codes, cfg.masked_token_id), device=device)
    pad = prefill_len - t0
    cond = pad_conditioning(prefix_conditioning, pad, dtype, device)
    pad_amount = torch.full((2,), pad, dtype=torch.int32, device=device)

    with torch.no_grad():
        carry = build_prefill_fn(statics)(params, cond, delayed_init, 1, pad_amount, cfg_scale,
                                          row_generators(seed, 1, device))
        c, n_pass, n_accept = spec_decode(params, statics, carry, pad_amount, cfg_scale,
                                          max_steps=max_new_tokens + n_q - 2)
    stop = c.stop_offset.cpu().numpy()
    offsets = np.where(stop >= 0, stop, c.offset)
    out, _lengths = postprocess_codes_batched(c.delayed_codes.cpu().numpy(), offsets, cfg)
    if not return_stats:
        return out
    return out, {"passes": n_pass, "accepted": n_accept, "frames": c.steps_done,
                 "acceptance": n_accept / max(n_pass, 1)}
