"""Token sampling: min-p / top-p / top-k / unified + repetition penalty.

Port of the static-parameter path of ``zonos_tpu/ops/sampling.py``: the same
filters on the last (vocab) axis, and the same exponential-race draw
(``argmax(probs / q)``, q ~ Exp(1)). The noise comes from one
``torch.Generator`` per batch row, so row i's draw depends only on its own
chain, as JAX's per-row keys do; tests inject the same numpy noise into both
packages through ``noise``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Static sampling configuration (defaults match the reference generate())."""

    temperature: float = 1.0
    top_p: float = 0.0
    top_k: int = 0
    min_p: float = 0.0
    linear: float = 0.0
    conf: float = 0.0
    quad: float = 0.0
    repetition_penalty: float = 3.0
    repetition_penalty_window: int = 2


def apply_unified(probs: torch.Tensor, linear: float, conf: float, quad: float) -> torch.Tensor:
    """NovelAI unified sampler."""
    logprobs = torch.log(probs.clamp(min=1e-20))
    entropy = -(probs * logprobs).sum(dim=-1, keepdim=True)
    raw = logprobs * (linear + entropy * conf) - logprobs.square() * quad
    return torch.softmax(raw, dim=-1)


def apply_top_k(probs: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k most probable tokens."""
    k = min(k, probs.shape[-1])
    pivot = torch.topk(probs, k, dim=-1).values[..., -1:]
    probs = torch.where(probs < pivot, torch.zeros_like(probs), probs)
    return probs / probs.sum(dim=-1, keepdim=True)


def apply_top_p(probs: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering: drop tokens whose cumulative probability, excluding
    themselves, exceeds p (sorted descending, stable order)."""
    sort_idx = torch.argsort(-probs, dim=-1, stable=True)
    probs_sort = torch.gather(probs, -1, sort_idx)
    probs_sum = torch.cumsum(probs_sort, dim=-1)
    keep = (probs_sum - probs_sort) <= p
    probs_sort = probs_sort * keep.to(probs.dtype)
    probs = torch.zeros_like(probs).scatter(-1, sort_idx, probs_sort)
    return probs / probs.sum(dim=-1, keepdim=True)


def apply_min_p(probs: torch.Tensor, min_p: float) -> torch.Tensor:
    """Drop tokens below min_p * max_prob."""
    top = probs.amax(dim=-1, keepdim=True)
    probs = torch.where(probs < min_p * top, torch.zeros_like(probs), probs)
    return probs / probs.sum(dim=-1, keepdim=True)


def apply_repetition_penalty(
    logits: torch.Tensor,
    generated_tokens: torch.Tensor,
    penalty: float,
    window: int,
    valid_len: int | torch.Tensor | None = None,
) -> torch.Tensor:
    """CTRL repetition penalty: factor = penalty ** (occurrences in the window).

    logits [..., n_q, V]; generated_tokens [..., n_q, W]; ``valid_len`` counts
    the valid positions at the end of the token buffer. Negative tokens (not
    yet generated) match no vocab entry, as JAX's one_hot of -1 does.
    """
    v = logits.shape[-1]
    toks = generated_tokens[..., -window:].clamp(max=v - 1)
    onehot = (toks[..., None] == torch.arange(v, device=logits.device)).to(logits.dtype)
    if valid_len is not None:
        w = toks.shape[-1]
        pos = torch.arange(w, device=logits.device)
        mask = (pos >= (w - valid_len)).to(logits.dtype)
        onehot = onehot * mask[..., :, None]
    counts = onehot.sum(dim=-2)
    factors = torch.pow(torch.tensor(penalty, dtype=logits.dtype, device=logits.device), counts)
    return torch.where(logits <= 0, logits * factors, logits / factors)


def exponential_noise(shape: Sequence[int], generators: Sequence[torch.Generator], device) -> torch.Tensor:
    """Exp(1) noise [B, *shape[1:]]; row i is drawn from generators[i] only."""
    assert len(generators) == shape[0], (len(generators), shape)
    rows = [
        torch.empty(tuple(shape[1:]), dtype=torch.float32, device=device).exponential_(generator=g)
        for g in generators
    ]
    return torch.stack(rows)


def sample_from_logits(
    logits: torch.Tensor,
    params: SamplingParams = SamplingParams(),
    generators: Sequence[torch.Generator] | None = None,
    noise: torch.Tensor | None = None,
    generated_tokens: torch.Tensor | None = None,
    generated_valid_len: int | torch.Tensor | None = None,
) -> torch.Tensor:
    """Sample int32 tokens [..., n_q] from logits [..., n_q, V].

    The draw takes ``noise`` when given, else Exp(1) noise from one generator
    per leading row. Greedy (temperature 0) needs neither.
    """
    if params.repetition_penalty != 1.0 and generated_tokens is not None:
        logits = apply_repetition_penalty(
            logits, generated_tokens, params.repetition_penalty,
            params.repetition_penalty_window, valid_len=generated_valid_len,
        )
    if params.temperature > 0:
        probs = torch.softmax(logits.float() / params.temperature, dim=-1)
        if params.linear > 0.0:
            probs = apply_unified(probs, params.linear, params.conf, params.quad)
        if params.top_p > 0:
            probs = apply_top_p(probs, params.top_p)
        if params.top_k > 0:
            probs = apply_top_k(probs, params.top_k)
        if params.min_p > 0:
            probs = apply_min_p(probs, params.min_p)
        if noise is None:
            noise = exponential_noise(probs.shape, generators, probs.device)
        return torch.argmax(probs / noise, dim=-1).to(torch.int32)
    return torch.argmax(logits, dim=-1).to(torch.int32)
