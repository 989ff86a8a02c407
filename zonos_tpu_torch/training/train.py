"""Training: teacher-forced next-frame prediction over delayed codes (port of
``zonos_tpu/training/train.py``).

Given prefix conditioning embeddings and the delay-patterned code stream,
predict each next frame's codebook tokens with per-codebook cross-entropy;
masked and out-of-head-range targets weigh 0. The forward is the backbone
without a cache (``models.backbone.backbone_forward(..., cache=None)``), the
embeddings and the heads, under plain autograd: the weights are float and
S > 1, so no decode kernel runs. ``remat=True`` recomputes each layer in the
backward pass (JAX's ``ZONOS_REMAT=1``).

The optimizer is optax's ``clip_by_global_norm(1.0)`` then ``adamw`` on a
``warmup_cosine_decay_schedule``, written out as plain tensor arithmetic
(``Optimizer``), so that an update equals optax's: g is scaled by
max/‖g‖ only when ‖g‖ ≥ max, eps sits outside the root, the decay is
``lr·wd·p`` on every leaf, and the schedule is read at the update count
before the increment (the first update has lr 0).

``make_sharded_train_step`` runs the same step over a (dp, tp) mesh
(``parallel.mesh``): each rank holds its tp shards and its dp rows
(``shard_batch``); the NLL and weight sums and the gradients are summed over
dp before the one division, and the clip's norm counts each sharded leaf's
squares summed over tp and each replicated leaf once, so the step computes
the one-device step's function.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from zonos_tpu_torch.config import ZonosConfig
from zonos_tpu_torch.models.backbone import backbone_forward
from zonos_tpu_torch.runtime.generate import apply_heads, embed_codes


# ---------------------------------------------------------------------------
# Param trees
# ---------------------------------------------------------------------------

def named_leaves(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(path, tensor) for every tensor of a nested dict/list tree, None skipped;
    dict keys in sorted order (JAX's tree order), paths joined by "/"."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in named_leaves(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [leaf for i, v in enumerate(tree) for leaf in named_leaves(v, f"{prefix}{i}/")]
    return [] if tree is None else [(prefix[:-1], tree)]


@contextlib.contextmanager
def _requires_grad(tensors):
    """Leaves that take gradients for the span of one step only, so that the
    params stay plain tensors for inference outside it."""
    for t in tensors:
        t.requires_grad_(True)
    try:
        yield
    finally:
        for t in tensors:
            t.requires_grad_(False)


# ---------------------------------------------------------------------------
# Optimizer: optax's clip_by_global_norm + adamw + warmup-cosine schedule
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class OptState:
    count: int  # updates applied so far
    mu: list  # first moments, one per leaf
    nu: list  # second moments


# JAX's make_optimizer: clip_by_global_norm(1.0), adamw(b1 0.9, b2 0.95, eps 1e-8),
# warmup_cosine_decay_schedule(0, lr, warmup, 10_000)
MAX_NORM, B1, B2, EPS, DECAY_STEPS = 1.0, 0.9, 0.95, 1e-8, 10_000


@dataclasses.dataclass(frozen=True)
class Optimizer:
    lr: float = 1e-4
    weight_decay: float = 0.01
    warmup: int = 100

    def schedule(self, count: int) -> float:
        """optax.warmup_cosine_decay_schedule(0, lr, warmup, DECAY_STEPS) at ``count``."""
        if count < self.warmup:  # linear 0 → lr
            return -self.lr * (1.0 - min(max(count, 0), self.warmup) / self.warmup) + self.lr
        t = min(count - self.warmup, DECAY_STEPS - self.warmup)
        return self.lr * 0.5 * (1.0 + math.cos(math.pi * t / (DECAY_STEPS - self.warmup)))

    def init(self, leaves: list) -> OptState:
        return OptState(count=0, mu=[torch.zeros_like(p) for p in leaves], nu=[torch.zeros_like(p) for p in leaves])

    @torch.no_grad()
    def update(self, grads: list, state: OptState, leaves: list, g_norm: torch.Tensor | None = None) -> None:
        """Apply one update to ``leaves`` in place and advance ``state``.
        ``g_norm``: the global gradient norm the clip reads, where the grads
        are shards of it (default: their own norm)."""
        if g_norm is None:
            g_norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
        clip = torch.where(g_norm < MAX_NORM, torch.ones_like(g_norm), MAX_NORM / g_norm)
        lr = self.schedule(state.count)
        count = state.count + 1
        bc1, bc2 = 1.0 - B1 ** count, 1.0 - B2 ** count
        for p, g, mu, nu in zip(leaves, grads, state.mu, state.nu):
            g = g * clip.to(g.dtype)
            mu.mul_(B1).add_(g, alpha=1.0 - B1)
            nu.mul_(B2).addcmul_(g, g, value=1.0 - B2)
            u = (mu / bc1).div_((nu / bc2).sqrt_().add_(EPS))
            u.add_(p, alpha=self.weight_decay)
            p.add_(u, alpha=-lr)
        state.count = count


def make_optimizer(lr: float = 1e-4, weight_decay: float = 0.01, warmup: int = 100) -> Optimizer:
    return Optimizer(lr=lr, weight_decay=weight_decay, warmup=warmup)


class TrainState(NamedTuple):
    params: dict  # updated in place by the step
    opt_state: OptState
    step: int


def trainable_leaves(params: dict) -> list:
    """The float leaves of a param tree, in ``named_leaves`` order."""
    return [t for _, t in named_leaves(params) if t.is_floating_point()]


def init_train_state(params: dict, optimizer: Optimizer) -> TrainState:
    return TrainState(params=params, opt_state=optimizer.init(trainable_leaves(params)), step=0)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def _tensor(a, device, dtype=None) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    return t.to(device=device, dtype=dtype) if dtype is not None else t.to(device)


def forward_logits(params: dict, cfg: ZonosConfig, cond_emb, codes, remat: bool = False,
                   mesh=None) -> torch.Tensor:
    """Cache-free forward of [cond_emb; embed(codes)] → f32 logits [B, n_q, S, Vh]
    at the code positions (cond_emb [B, Lc, D], codes [B, n_q, S]). ``mesh``:
    params and cfg are a tp rank's (``shard_params``, ``local_config``)."""
    emb = params["embeddings"]
    x_codes = embed_codes(emb, _tensor(codes, emb.device))
    cond = _tensor(cond_emb, emb.device, x_codes.dtype)
    x = torch.cat([cond, x_codes], dim=1)
    pad = torch.zeros((x.shape[0],), dtype=torch.int32, device=x.device)
    h, _ = backbone_forward(params["backbone"], cfg.backbone, x, None, write_start=0, pad_amount=pad,
                            attend_len=x.shape[1], remat=remat, mesh=mesh)
    return apply_heads(params["heads"], h[:, cond.shape[1]:], cfg.codebook_dimension)


def _target_weights(loss_mask: torch.Tensor, targets: torch.Tensor, vh: int, dtype) -> torch.Tensor:
    """[B, n_q, S-1] weights: 1 for a real next-frame target, 0 for padding
    (outside the loss mask), delay-pattern MASK tokens and out-of-head-range ids."""
    return loss_mask[:, None, :].to(dtype) * (targets < vh).to(dtype)


def count_targets(delayed_codes, loss_mask, vh: int) -> int:
    """The targets a batch trains on: ``loss_terms``' weight sum, padded
    positions excluded (``vh``: the heads' vocabulary)."""
    targets = torch.as_tensor(np.asarray(delayed_codes))[..., 1:]
    return int(_target_weights(torch.as_tensor(np.asarray(loss_mask)), targets, vh, torch.int64).sum())


def loss_terms(params: dict, cfg: ZonosConfig, cond_emb, delayed_codes, loss_mask,
               remat: bool = False, mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(weighted-NLL sum, weight sum) over [B, n_q, S-1] next-frame targets.

    Kept un-normalized so gradient accumulation sums both over microbatches
    and divides once (``build_train_step``)."""
    dev = params["embeddings"].device
    delayed = _tensor(delayed_codes, dev).long()
    logits = forward_logits(params, cfg, cond_emb, delayed[..., :-1], remat=remat, mesh=mesh)
    targets = delayed[..., 1:]  # predict frame t+1 from <= t
    vh = logits.shape[-1]
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets.clamp(0, vh - 1)[..., None])[..., 0]  # [B, n_q, S-1]
    w = _target_weights(_tensor(loss_mask, dev), targets, vh, nll.dtype)
    return (nll * w).sum(), w.sum()


def loss_fn(params: dict, cfg: ZonosConfig, cond_emb, delayed_codes, loss_mask, remat: bool = False) -> torch.Tensor:
    """Mean per-token cross-entropy over all codebooks."""
    nll_sum, w_sum = loss_terms(params, cfg, cond_emb, delayed_codes, loss_mask, remat=remat)
    return nll_sum / torch.clamp(w_sum, min=1.0)


def _grads(loss: torch.Tensor, leaves: list) -> list:
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]


def value_and_grad(loss_of, leaves: list, accum_steps: int, cond_emb, delayed_codes, loss_mask):
    """(loss, grads of ``leaves``) of the token-weighted mean loss.

    ``loss_of(cond, codes, mask)`` returns (nll_sum, w_sum). With
    ``accum_steps > 1`` the batch is split into that many microbatches along
    axis 0; their NLL and weight sums and their gradients are summed and
    divided once, as JAX's scan does (grad(Σ nll·w / W) = Σ grad(nll·w) / W:
    w does not depend on the params)."""
    if accum_steps == 1:
        with _requires_grad(leaves):
            nll, w = loss_of(cond_emb, delayed_codes, loss_mask)
            loss = nll / torch.clamp(w, min=1.0)
            return loss.detach(), _grads(loss, leaves)
    nll_sum, w_sum, acc = grad_sums(loss_of, leaves, accum_steps, cond_emb, delayed_codes, loss_mask)
    denom = torch.clamp(w_sum, min=1.0)
    return nll_sum / denom, [g / denom for g in acc]


def grad_sums(loss_of, leaves: list, accum_steps: int, cond_emb, delayed_codes, loss_mask):
    """(NLL sum, weight sum, gradients of the NLL sum) over ``accum_steps``
    microbatches along axis 0, not yet normalized."""
    b = delayed_codes.shape[0]
    if b % accum_steps:
        raise ValueError(f"a batch of {b} does not split into {accum_steps} microbatches")
    m = b // accum_steps
    nll_sum = w_sum = 0.0
    acc = None
    with _requires_grad(leaves):
        for i in range(accum_steps):
            mb = (a[i * m:(i + 1) * m] for a in (cond_emb, delayed_codes, loss_mask))
            nll, w = loss_of(*mb)
            g = _grads(nll, leaves)
            acc = g if acc is None else [a + b_ for a, b_ in zip(acc, g)]
            nll_sum, w_sum = nll_sum + nll.detach(), w_sum + w.detach()
    return nll_sum, w_sum, acc


def build_train_step(cfg: ZonosConfig, optimizer: Optimizer, accum_steps: int = 1, remat: bool = False):
    """Returns train_step(state, cond_emb, delayed_codes, loss_mask) → (state, loss).

    The params of ``state`` are updated in place; gradients flow into every
    float leaf. ``accum_steps > 1`` accumulates gradients over microbatches
    (``value_and_grad``); ``remat`` recomputes each layer in the backward pass.
    """

    def train_step(state: TrainState, cond_emb, delayed_codes, loss_mask):
        leaves = trainable_leaves(state.params)
        loss, grads = value_and_grad(
            lambda c, d, m: loss_terms(state.params, cfg, c, d, m, remat=remat),
            leaves, accum_steps, cond_emb, delayed_codes, loss_mask,
        )
        optimizer.update(grads, state.opt_state, leaves)
        return TrainState(state.params, state.opt_state, state.step + 1), loss

    return train_step


# ---------------------------------------------------------------------------
# Sharded step: dp × tp over a parallel.mesh.Mesh
# ---------------------------------------------------------------------------

def sharded_value_and_grad(mesh, loss_of, leaves: list, accum_steps: int, cond_emb, delayed_codes, loss_mask):
    """(loss, grads of this rank's ``leaves``) of the token-weighted mean loss
    over the whole batch: the NLL and weight sums and the gradients summed
    over dp, then divided once by the global weight sum."""
    nll, w, grads = grad_sums(loss_of, leaves, accum_steps, cond_emb, delayed_codes, loss_mask)
    if mesh.dp > 1:
        sums = torch.stack([nll, w])
        for t in (sums, *grads):
            dist.all_reduce(t, group=mesh.dp_group)
        nll, w = sums
    denom = torch.clamp(w, min=1.0)
    return nll / denom, [g / denom for g in grads]


def sharded_grad_norm(mesh, grads: list, sharded: list) -> torch.Tensor:
    """The whole model's gradient norm: each tp-sharded leaf's squares summed
    over tp, each replicated leaf counted once."""
    sq = [(g.float() ** 2).sum() for g in grads]
    zero = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    part = sum((q for q, s in zip(sq, sharded) if s), zero)
    if mesh.tp > 1:
        dist.all_reduce(part, group=mesh.tp_group)
    return torch.sqrt(part + sum((q for q, s in zip(sq, sharded) if not s), zero))


def make_sharded_train_step(mesh, cfg: ZonosConfig, optimizer: Optimizer, params: dict, accum_steps: int = 1,
                            remat: bool = False):
    """Shard ``params`` (the whole model's, on every rank) over the mesh and
    build the step. Returns (state, step): ``state.params`` are this rank's
    shards, copies that share nothing with ``params``; ``step(state,
    cond_emb, delayed_codes, loss_mask)`` takes this rank's rows
    (``shard_batch``) and returns (state, the global loss), the shards and
    moments updated in place."""
    import copy

    from zonos_tpu_torch.parallel.mesh import local_config, shard_axes, shard_params

    axes = shard_axes(cfg, params)
    local = copy.deepcopy(shard_params(mesh, cfg, params))  # replicated leaves are params' own tensors
    sharded = [axes[p] is not None for p, t in named_leaves(local) if t.is_floating_point()]
    lcfg = local_config(cfg, mesh.tp)
    state = init_train_state(local, optimizer)

    def step(state: TrainState, cond_emb, delayed_codes, loss_mask):
        leaves = trainable_leaves(state.params)
        loss, grads = sharded_value_and_grad(
            mesh, lambda c, d, m: loss_terms(state.params, lcfg, c, d, m, remat=remat, mesh=mesh),
            leaves, accum_steps, cond_emb, delayed_codes, loss_mask,
        )
        optimizer.update(grads, state.opt_state, leaves, g_norm=sharded_grad_norm(mesh, grads, sharded))
        return TrainState(state.params, state.opt_state, state.step + 1), loss

    return state, step


def shard_batch(mesh, *arrays):
    """This dp rank's rows (``parallel.mesh.batch_rows``) of each batch array,
    as tensors on the mesh's device."""
    from zonos_tpu_torch.parallel.mesh import batch_rows

    out = tuple(_tensor(a[batch_rows(mesh, len(a))], mesh.device) for a in arrays)
    return out if len(out) > 1 else out[0]
