"""The port's training step (``zonos_tpu_torch/training/train.py``) against the
JAX package's (``zonos_tpu/training/train.py``).

Tiny configs (transformer d 64 × 2 layers; hybrid d 64 × 3 layers, whose
Mamba layers run the port's ``ssd_chunked`` under autograd), float32 on the
CPU, the same params (bridged) and the same numpy batch: the NLL and weight
sums and the loss at 1e-5, every leaf's gradient against
``jax.value_and_grad`` at 1e-4, the params after 3 optimizer steps against
optax's at 1e-5 (warmup included: the first update has lr 0), the optimizer
alone against optax on both sides of the clip, ``accum_steps=2`` against 1,
and ``remat`` on against off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from zonos_tpu.config import tiny_hybrid_config as j_tiny_hybrid
from zonos_tpu.config import tiny_transformer_config as j_tiny
from zonos_tpu.models.zonos import Zonos as JZonos
from zonos_tpu.ops.delay_pattern import apply_delay_pattern_np
from zonos_tpu.training import train as JT
from zonos_tpu_torch.bridge import params_from_jax
from zonos_tpu_torch.config import tiny_hybrid_config, tiny_transformer_config
from zonos_tpu_torch.training import train as TT

CONFIGS = {"transformer": (j_tiny, tiny_transformer_config), "hybrid": (j_tiny_hybrid, tiny_hybrid_config)}


def _flat(tree, prefix=""):
    """{path: numpy array} of a nested dict/list tree, None skipped (named_leaves' paths)."""
    if isinstance(tree, dict):
        return {p: v for k in sorted(tree) for p, v in _flat(tree[k], f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, t in enumerate(tree) for p, v in _flat(t, f"{prefix}{i}/").items()}
    return {} if tree is None else {prefix[:-1]: np.asarray(tree)}


def batch(seed=0, b=2, lc=4, frames=12, d=64, mask_token=1025):
    """Conditioning [B, Lc, D], delayed codes [B, 9, frames + 9] with MASK tails,
    and a loss mask with each row cut at its own length."""
    rng = np.random.default_rng(seed)
    cond = rng.normal(size=(b, lc, d)).astype(np.float32)
    codes = np.full((b, 9, frames), mask_token, np.int32)
    lengths = [frames - 3 * i for i in range(b)]
    for i, t in enumerate(lengths):
        codes[i, :, :t] = rng.integers(0, 1024, size=(9, t))
    delayed = apply_delay_pattern_np(codes, mask_token)
    mask = np.arange(delayed.shape[-1] - 1)[None, :] < (np.asarray(lengths)[:, None] + 9)
    return cond, delayed, mask


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def models(request):
    jcfg, tcfg = CONFIGS[request.param]
    jm = JZonos.from_config(jcfg(), seed=0, dtype=jnp.float32)
    jparams = {k: jm.params[k] for k in ("embeddings", "heads", "backbone")}
    return request.param, jcfg(), tcfg(), jparams


def _tparams(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams))


# JAX's loss and gradient, traced once per config (the batches share a shape)
j_value_and_grad = jax.jit(jax.value_and_grad(JT.loss_fn), static_argnums=1)


def test_loss_terms_and_loss_match_jax(models):
    _name, jcfg, tcfg, jparams = models
    cond, delayed, mask = batch()
    j_nll, j_w = jax.jit(JT.loss_terms, static_argnums=1)(jparams, jcfg, cond, delayed, mask)
    j_loss, _ = j_value_and_grad(jparams, jcfg, cond, delayed, mask)
    tparams = _tparams(jparams)
    t_nll, t_w = TT.loss_terms(tparams, tcfg, cond, delayed, mask)
    t_loss = TT.loss_fn(tparams, tcfg, cond, delayed, mask)
    assert float(t_w) == float(j_w) < mask.size * 9  # MASK targets and the masked tail weigh 0
    np.testing.assert_allclose(float(t_nll), float(j_nll), rtol=1e-5)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)


def test_gradients_of_every_leaf_match_jax(models):
    _name, jcfg, tcfg, jparams = models
    cond, delayed, mask = batch(seed=1)
    j_loss, j_grads = j_value_and_grad(jparams, jcfg, cond, delayed, mask)
    tparams = _tparams(jparams)
    leaves = TT.trainable_leaves(tparams)
    loss, grads = TT.value_and_grad(lambda c, d, m: TT.loss_terms(tparams, tcfg, c, d, m), leaves, 1,
                                    cond, delayed, mask)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    ref = _flat(jax.tree.map(np.asarray, j_grads))
    paths = [p for p, _ in TT.named_leaves(tparams)]
    assert sorted(paths) == sorted(ref) and len(paths) == len(grads)
    for path, g in zip(paths, grads):
        r = ref[path]
        assert np.abs(r).max() > 0, path  # every leaf takes a gradient: nothing under no_grad
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4, atol=1e-4 * np.abs(r).max(), err_msg=path)
    assert not any(p.requires_grad for p in leaves)  # the step's grad flags are put back


def test_three_steps_match_optax(models):
    """build_train_step × 3 (warmup 2: lr 0, lr/2, then the cosine) against
    JAX's on optax: losses at 1e-5, the first update a no-op, params at 1e-5.

    Adam divides each element's first moment by the root of its second, so an
    element whose gradient is near the two packages' rounding gap takes a
    step that amplifies it. Params hold 1e-5 but for at most 1e-5 of the
    elements, each of them one whose gradient was non-zero and below 1e-4 of
    its leaf's largest at some step, and within the steps' summed lr."""
    _name, jcfg, tcfg, jparams = models
    cond, delayed, mask = batch(seed=2)
    lr = 3e-3
    jopt = JT.make_optimizer(lr=lr, warmup=2)
    jstate = JT.init_train_state(jparams, jopt)
    jstep = jax.jit(JT.build_train_step(jcfg, jopt))
    tparams = _tparams(jparams)
    start = {p: t.clone() for p, t in TT.named_leaves(tparams)}
    topt = TT.make_optimizer(lr=lr, warmup=2)
    tstate = TT.init_train_state(tparams, topt)
    tstep = TT.build_train_step(tcfg, topt)
    noise_level = {}
    leaves = TT.trainable_leaves(tparams)
    for i in range(3):
        _, grads = TT.value_and_grad(lambda c, d, m: TT.loss_terms(tparams, tcfg, c, d, m), leaves, 1,
                                     cond, delayed, mask)
        for (path, _), g in zip(TT.named_leaves(tparams), grads):
            g = g.numpy()
            low = (g != 0) & (np.abs(g) < 1e-4 * np.abs(g).max())  # a zero gradient is exact on both sides
            noise_level[path] = low | noise_level.get(path, low)
        jstate, jloss = jstep(jstate, cond, delayed, mask)
        tstate, tloss = tstep(tstate, cond, delayed, mask)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        if i == 0:
            assert all(torch.equal(t, start[p]) for p, t in TT.named_leaves(tstate.params))
    assert tstate.step == 3 and tstate.opt_state.count == 3
    ref = _flat(jax.tree.map(np.asarray, jstate.params))
    lr_sum = sum(topt.schedule(c) for c in range(3))
    n_off = n_all = 0
    for path, t in TT.named_leaves(tstate.params):
        got, want = t.numpy(), ref[path]
        off = ~np.isclose(got, want, rtol=1e-5, atol=1e-5)
        assert not (off & ~noise_level[path]).any(), path
        assert np.abs(got[off] - want[off]).max(initial=0.0) <= lr_sum, path
        assert not torch.equal(t, start[path]), path
        n_off, n_all = n_off + int(off.sum()), n_all + off.size
    assert n_off <= 1e-5 * n_all, (n_off, n_all)


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])
def test_optimizer_matches_optax_on_both_sides_of_the_clip(grad_scale):
    """Four updates of random grads with ‖g‖ below (1e-3) and above (10) the
    clip of 1: params and the schedule at each count equal optax's."""
    rng = np.random.default_rng(3)
    shapes = [(3, 5), (7,), (2, 4, 6)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(rng.normal(size=s) * grad_scale / 4).astype(np.float32) for s in shapes] for _ in range(4)]
    jopt = JT.make_optimizer(lr=1e-2, weight_decay=0.1, warmup=2)
    jp = [jnp.asarray(p) for p in params]
    jstate = jopt.init(jp)
    topt = TT.make_optimizer(lr=1e-2, weight_decay=0.1, warmup=2)
    tp = [torch.from_numpy(p.copy()) for p in params]
    tstate = topt.init(tp)
    sched = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 10_000)
    for count, g in enumerate(grads):
        np.testing.assert_allclose(topt.schedule(count), float(sched(count)), rtol=1e-6)
        updates, jstate = jopt.update([jnp.asarray(x) for x in g], jstate, jp)
        jp = optax.apply_updates(jp, updates)
        topt.update([torch.from_numpy(x) for x in g], tstate, tp)
        for t, j in zip(tp, jp):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(topt.schedule(5000), float(sched(5000)), rtol=1e-6)


def test_accum_steps_2_equals_1(models):
    """Two microbatches with different valid-token counts: summed and divided
    once, the loss and gradients of the whole batch."""
    _name, _jcfg, tcfg, jparams = models
    cond, delayed, mask = batch(seed=4, b=4)
    tparams = _tparams(jparams)
    leaves = TT.trainable_leaves(tparams)

    def run(accum):
        return TT.value_and_grad(lambda c, d, m: TT.loss_terms(tparams, tcfg, c, d, m), leaves, accum,
                                 cond, delayed, mask)

    (l1, g1), (l2, g2) = run(1), run(2)
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-5)
    for a, b in zip(g2, g1):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5 * float(b.abs().max()))


def test_remat_equals_no_remat(models):
    _name, _jcfg, tcfg, jparams = models
    cond, delayed, mask = batch(seed=5)
    tparams = _tparams(jparams)
    leaves = TT.trainable_leaves(tparams)
    out = [TT.value_and_grad(lambda c, d, m: TT.loss_terms(tparams, tcfg, c, d, m, remat=r), leaves, 1,
                             cond, delayed, mask) for r in (False, True)]
    (l0, g0), (l1, g1) = out
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-6)
    for a, b in zip(g1, g0):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7 * float(b.abs().max()))


def test_train_step_with_remat_and_accum_lowers_the_loss(models):
    """The step as a user runs it (remat on, 2 microbatches): finite, falling losses."""
    _name, _jcfg, tcfg, jparams = models
    cond, delayed, mask = batch(seed=6, b=4)
    opt = TT.make_optimizer(lr=3e-3, warmup=1)
    state = TT.init_train_state(_tparams(jparams), opt)
    step = TT.build_train_step(tcfg, opt, accum_steps=2, remat=True)
    losses = []
    for _ in range(5):
        state, loss = step(state, cond, delayed, mask)
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    with pytest.raises(ValueError, match="microbatches"):
        TT.build_train_step(tcfg, opt, accum_steps=3)(state, cond, delayed, mask)


def test_count_targets_is_the_loss_weight_sum(models):
    """``count_targets`` (the training rate's numerator) is JAX's weight sum:
    padded positions and MASK tokens are not counted."""
    _name, jcfg, tcfg, jparams = models
    cond, delayed, mask = batch(seed=6, b=3)
    n = TT.count_targets(delayed, mask, tcfg.head_vocab_size)
    _nll, w = jax.jit(JT.loss_terms, static_argnums=1)(jparams, jcfg, cond, delayed, mask)
    assert n == int(w) and n < delayed.shape[0] * 9 * (delayed.shape[-1] - 1)
