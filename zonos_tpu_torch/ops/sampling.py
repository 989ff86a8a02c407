"""Token sampling: min-p / top-p / top-k / unified + repetition penalty.

Port of ``zonos_tpu/ops/sampling.py``: the same filters on the last (vocab)
axis, and the same exponential-race draw (``argmax(probs / q)``, q ~ Exp(1)).
The noise comes from one ``torch.Generator`` per batch row, so row i's draw
depends only on its own chain, as JAX's per-row keys do; tests inject the
same numpy noise into both packages through ``noise``.

Two flavours of parameters, as in JAX: ``SamplingParams`` (Python values,
one set for the whole batch) and ``RuntimeSamplingParams`` (one value per
row, [B] tensors on the device), with which the continuous engine samples
requests of different settings in one batch. Each runtime row gives the bits
the static path gives for its own settings: every filter is computed and a
per-row ``where`` keeps it or the untouched distribution. Only ``top_k``
(shape-affecting) and the repetition window stay batch-wide.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
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


_RUNTIME_FIELDS = ("temperature", "top_p", "min_p", "linear", "conf", "quad", "repetition_penalty")


@dataclasses.dataclass
class RuntimeSamplingParams:
    """Per-row sampling parameters: each field is a [B] f32 tensor.

    ``host`` mirrors the fields as numpy arrays, so that the filters that run
    only when some row uses them (unified, top-p) are chosen without reading
    the device. ``top_k`` and the repetition window are not here: they are
    batch-wide and passed to ``sample_from_logits_runtime`` separately.
    """

    temperature: torch.Tensor
    top_p: torch.Tensor
    min_p: torch.Tensor
    linear: torch.Tensor
    conf: torch.Tensor
    quad: torch.Tensor
    repetition_penalty: torch.Tensor
    host: dict = dataclasses.field(repr=False, default_factory=dict)

    @staticmethod
    def from_host(host: dict, device=None) -> "RuntimeSamplingParams":
        host = {k: np.asarray(host[k], np.float32) for k in _RUNTIME_FIELDS}
        return RuntimeSamplingParams(**{k: torch.as_tensor(host[k], device=device) for k in _RUNTIME_FIELDS},
                                     host=host)

    @staticmethod
    def from_static(p: SamplingParams, b: int = 1, device=None) -> "RuntimeSamplingParams":
        return RuntimeSamplingParams.from_host({k: np.full((b,), getattr(p, k), np.float32)
                                                for k in _RUNTIME_FIELDS}, device)

    def set_row(self, slot: int, row: "RuntimeSamplingParams") -> "RuntimeSamplingParams":
        """A copy with row ``slot`` replaced by ``row``'s only row."""
        host = {k: self.host[k].copy() for k in _RUNTIME_FIELDS}
        for k in _RUNTIME_FIELDS:
            host[k][slot] = row.host[k][0]
        return RuntimeSamplingParams.from_host(host, self.temperature.device)

    def any(self, name: str) -> bool:
        """Whether some row's ``name`` is > 0 (read on the host)."""
        return bool((self.host[name] > 0).any())


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
    factors = torch.pow(torch.as_tensor(penalty, dtype=logits.dtype, device=logits.device), counts)
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


def sample_from_logits_runtime(
    logits: torch.Tensor,
    rt: RuntimeSamplingParams,
    *,
    top_k: int = 0,
    generators: Sequence[torch.Generator] | None = None,
    noise: torch.Tensor | None = None,
    generated_tokens: torch.Tensor | None = None,
    generated_valid_len: int | torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-row mirror of ``sample_from_logits``: logits [B, ..., V], each
    field of ``rt`` [B] → int32 tokens [B, ...].

    Each filter is computed and selected per row, so a row whose setting
    disables a filter keeps the untouched distribution: its tokens are the
    static path's for its own settings. The repetition penalty needs no
    select: a penalty of 1.0 multiplies or divides by exactly 1. The unified
    and top-p filters run only when some row uses them (``rt.host``).
    Every row draws its noise, greedy rows too, whose tokens are the argmax
    of the penalized logits.
    """
    nd = logits.ndim

    def bc(v: torch.Tensor) -> torch.Tensor:  # [B] → [B, 1, ...]
        return v.reshape(v.shape + (1,) * (nd - 1))

    if generated_tokens is not None:
        logits = apply_repetition_penalty(logits, generated_tokens, bc(rt.repetition_penalty),
                                          generated_tokens.shape[-1], valid_len=generated_valid_len)
    t = bc(rt.temperature)
    probs = torch.softmax(logits.float() / torch.where(t > 0, t, torch.ones_like(t)), dim=-1)
    if rt.any("linear"):
        probs = torch.where(bc(rt.linear) > 0, apply_unified(probs, bc(rt.linear), bc(rt.conf), bc(rt.quad)), probs)
    if rt.any("top_p"):
        probs = torch.where(bc(rt.top_p) > 0, apply_top_p(probs, bc(rt.top_p)), probs)
    if top_k > 0:
        probs = apply_top_k(probs, top_k)
    probs = torch.where(bc(rt.min_p) > 0, apply_min_p(probs, bc(rt.min_p)), probs)
    if noise is None:
        noise = exponential_noise(probs.shape, generators, probs.device)
    sampled = torch.argmax(probs / noise, dim=-1)
    greedy = (rt.temperature <= 0).reshape((-1,) + (1,) * (nd - 2))
    return torch.where(greedy, torch.argmax(logits, dim=-1), sampled).to(torch.int32)
