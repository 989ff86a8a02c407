"""The sharded train step (``zonos_tpu_torch/training/train.py``:
``make_sharded_train_step``, ``shard_batch``) on dp 2 × tp 2, one group of 4
gloo ranks on the CPU, against JAX's unsharded ``loss_fn`` and the port's
one-device step.

The ranks are spawned once for the file and run every case's rank side
while JAX computes its losses in this process; each test asserts on its
part. Two models, the port's from seed 0 at float32: the transformer of
``tests/test_parallel_training.py``'s ``_tiny_cfg(4)`` (4 query and 4 KV
heads, MLP 64) and the tiny hybrid. The batch: 4 rows, one of them masked
after 5 frames, so the dp halves weigh differently.

* the sharded loss equals JAX's unsharded ``loss_fn`` at rtol 1e-5;
* two AdamW steps (warmup 1: the first has lr 0) equal the port's
  one-device ``build_train_step`` at rtol 2e-5 / atol 2e-6, but for the few
  elements Adam amplifies (``test_torch_training.py``'s bound: gradient
  non-zero and under 1e-4 of its leaf's largest, within the summed lr);
* 3 steps lower the loss on the fixed batch;
* replicated leaves' gradients are identical on the two tp ranks of a dp
  index, and the global loss on all four;
* ``accum_steps=2`` with ``remat`` gives the plain step's loss and
  gradients at 1e-5.

The rank side imports no JAX: the ranks import this module afresh.
"""

import copy
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from zonos_tpu_torch.config import AttentionConfig, tiny_hybrid_config, tiny_transformer_config
from zonos_tpu_torch.models.zonos import Zonos
from zonos_tpu_torch.parallel.mesh import local_config, make_mesh, shard_axes, shard_params, shard_tree, spawn
from zonos_tpu_torch.training import train as T

LR = 1e-3


def _tiny_cfg4():
    """``_tiny_cfg(4)`` of tests/test_parallel_training.py, in the port's config."""
    cfg = tiny_transformer_config()
    bb = dataclasses.replace(cfg.backbone, attn_mlp_d_intermediate=64,
                             attn_cfg=AttentionConfig(num_heads=4, num_heads_kv=4))
    return dataclasses.replace(cfg, backbone=bb)


CASES = {"transformer": _tiny_cfg4, "hybrid": tiny_hybrid_config}


def _params(name: str) -> dict:
    m = Zonos.from_config(CASES[name](), seed=0, dtype=torch.float32, device="cpu")
    return {k: m.params[k] for k in ("embeddings", "heads", "backbone")}


def _batch():
    rng = np.random.default_rng(0)
    b, lc, s = 4, 4, 16
    cond = rng.normal(size=(b, lc, 64)).astype(np.float32)
    codes = rng.integers(0, 1024, size=(b, 9, s)).astype(np.int32)
    mask = np.ones((b, s - 1), bool)
    mask[0, 5:] = False
    return cond, codes, mask


def _np(leaves: dict) -> dict:
    return {p: t.detach().numpy().copy() for p, t in leaves.items()}


def _one_case(mesh, name):
    cfg = CASES[name]()
    params = _params(name)
    batch = _batch()
    local_batch = T.shard_batch(mesh, *batch)
    lcfg = local_config(cfg, mesh.tp)
    axes = shard_axes(cfg, params)
    out = {}

    # loss and gradients of the sharded forward, plain and with accum_steps=2 + remat
    local = shard_params(mesh, cfg, params)
    leaves = T.trainable_leaves(local)
    paths = [p for p, t in T.named_leaves(local) if t.is_floating_point()]
    for key, accum, remat in (("plain", 1, False), ("accum_remat", 2, True)):
        loss, grads = T.sharded_value_and_grad(
            mesh, lambda c, d, m: T.loss_terms(local, lcfg, c, d, m, remat=remat, mesh=mesh),
            leaves, accum, *local_batch)
        out[key] = (float(loss), _np(dict(zip(paths, grads))))
    out["replicated"] = [p for p in paths if axes[p] is None]

    # two sharded AdamW steps against the one-device step, then a third
    opt = T.make_optimizer(lr=LR, warmup=1)
    state, step = T.make_sharded_train_step(mesh, cfg, opt, params)
    ref_state = T.init_train_state(copy.deepcopy(params), opt)
    ref_step = T.build_train_step(cfg, opt)
    low = {}
    losses = []
    for i in range(3):
        if i < 2:  # the one-device gradients: where Adam may amplify rounding
            ref_leaves = T.trainable_leaves(ref_state.params)
            _, g = T.value_and_grad(lambda c, d, m: T.loss_terms(ref_state.params, cfg, c, d, m), ref_leaves, 1,
                                    *batch)
            g_local = dict(T.named_leaves(shard_tree(cfg, _tree_like(ref_state.params, g), mesh.tp, mesh.tp_rank)))
            for p, gl in g_local.items():
                gl = gl.numpy()
                now = (gl != 0) & (np.abs(gl) < 1e-4 * np.abs(gl).max())
                low[p] = now | low.get(p, now)
            ref_state, _ = ref_step(ref_state, *batch)
        state, loss = step(state, *local_batch)
        losses.append(float(loss))
        if i == 1:
            out["step2"] = _np(dict(T.named_leaves(state.params)))
            out["ref_step2"] = _np(dict(T.named_leaves(shard_tree(cfg, ref_state.params, mesh.tp, mesh.tp_rank))))
            out["start"] = _np(dict(T.named_leaves(shard_tree(cfg, params, mesh.tp, mesh.tp_rank))))
    out["low"] = low
    out["losses"] = losses
    out["lr_sum"] = sum(opt.schedule(c) for c in range(2))
    return out


def _tree_like(tree, flat: list):
    """``flat`` (one tensor per float leaf, in named_leaves order) in ``tree``'s shape."""
    it = iter(flat)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return None if t is None else next(it)

    return walk(tree)


def _rank_side(backend, device):
    torch.set_num_threads(1)
    mesh = make_mesh(dp=2, tp=2, backend=backend, device=device)
    return {"tp_rank": mesh.tp_rank, "dp_rank": mesh.dp_rank, **{name: _one_case(mesh, name) for name in CASES}}


@pytest.fixture(scope="module")
def ranks():
    """(each rank's results, {case: JAX's unsharded loss_fn})."""
    import jax

    from zonos_tpu.config import AttentionConfig as JAttention
    from zonos_tpu.config import tiny_hybrid_config as j_hybrid
    from zonos_tpu.config import tiny_transformer_config as j_tiny
    from zonos_tpu.training.train import loss_fn

    def numpy(tree):
        if isinstance(tree, dict):
            return {k: numpy(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return tuple(numpy(v) for v in tree)
        return None if tree is None else tree.numpy()

    jt = j_tiny()
    jt = dataclasses.replace(jt, backbone=dataclasses.replace(
        jt.backbone, attn_mlp_d_intermediate=64, attn_cfg=JAttention(num_heads=4, num_heads_kv=4)))
    jcfgs = {"transformer": jt, "hybrid": j_hybrid()}
    with ThreadPoolExecutor(1) as pool:
        group = pool.submit(spawn, _rank_side, 4, "gloo", "cpu", timeout=600)
        j_loss = {name: float(jax.jit(loss_fn, static_argnums=1)(numpy(_params(name)), c, *_batch()))
                  for name, c in jcfgs.items()}
        return group.result(), j_loss


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_loss_matches_jax(ranks, name):
    results, j_loss = ranks
    for r in results:
        np.testing.assert_allclose(r[name]["plain"][0], j_loss[name], rtol=1e-5)
        assert r[name]["losses"][0] == results[0][name]["losses"][0]  # one global loss on every rank


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_step_matches_one_device_step(ranks, name):
    n_off = n_all = 0
    for r in ranks[0]:
        res = r[name]
        for path, got in res["step2"].items():
            want, start = res["ref_step2"][path], res["start"][path]
            assert got.shape == want.shape, path
            assert not np.array_equal(got, start), path  # the second step moved every leaf
            off = ~np.isclose(got, want, rtol=2e-5, atol=2e-6)
            assert not (off & ~res["low"][path]).any(), path
            assert np.abs(got[off] - want[off]).max(initial=0.0) <= res["lr_sum"], path
            n_off, n_all = n_off + int(off.sum()), n_all + off.size
    assert n_off <= 1e-5 * n_all, (n_off, n_all)


@pytest.mark.parametrize("name", sorted(CASES))
def test_three_sharded_steps_lower_the_loss(ranks, name):
    for r in ranks[0]:
        losses = r[name]["losses"]
        assert all(np.isfinite(losses)) and losses[0] == losses[1] > losses[2], losses  # the first step has lr 0


@pytest.mark.parametrize("name", sorted(CASES))
def test_replicated_gradients_identical_across_tp(ranks, name):
    results = ranks[0]
    replicated = results[0][name]["replicated"]
    assert any("embeddings" in p for p in replicated) and any("norm" in p for p in replicated)
    for dp_rank in (0, 1):
        a, b = (r[name]["plain"][1] for r in results if r["dp_rank"] == dp_rank)
        for path in replicated:
            np.testing.assert_array_equal(a[path], b[path], err_msg=path)


@pytest.mark.parametrize("name", sorted(CASES))
def test_accum_steps_and_remat_match_the_plain_step(ranks, name):
    for r in ranks[0]:
        (l1, g1), (l2, g2) = r[name]["plain"], r[name]["accum_remat"]
        np.testing.assert_allclose(l2, l1, rtol=1e-5)
        for path, g in g1.items():
            np.testing.assert_allclose(g2[path], g, rtol=1e-5, atol=1e-5 * np.abs(g).max(), err_msg=path)
