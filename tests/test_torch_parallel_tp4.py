"""The sharded paths at tp 4 (``zonos_tpu_torch/parallel/``) against the
JAX package's one-device ``generate`` and the port's one-device runs, on
one group of 4 gloo ranks on the CPU.

The ranks are spawned once for the file (``ranks`` fixture) and run every
case's rank side while JAX runs its side in this process; each test asserts
on its part of the results. The models are the port's, from seed 0 at
float32, with 8 query and 4 KV heads so that attention splits over tp 4
(one KV head per rank):

* tp 4, greedy: the transformer (float, int8 weights with int8 KV, int4 at
  d 512: 128 rows of out_proj per rank, one group) and the hybrid (float,
  int8): codes identical to JAX's one-device ``generate`` on all 4 ranks;
* dp 2 × tp 2, B 4 at one int seed (transformer and hybrid): codes and
  lengths identical to the port's one-device run of all 4 rows;
* dp 1 × tp 4 train step (transformer and hybrid): the sharded loss and
  every leaf's gradient equal the one-device ``value_and_grad``'s at 1e-5,
  and the losses of 3 sharded steps equal those of the one-device
  ``build_train_step`` at 1e-5.

The rank side imports no JAX: the ranks import this module afresh.
"""

import copy
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from zonos_tpu_torch.config import tiny_hybrid_config, tiny_transformer_config
from zonos_tpu_torch.models.zonos import Zonos
from zonos_tpu_torch.ops.sampling import SamplingParams
from zonos_tpu_torch.parallel.mesh import local_config, make_mesh, shard_params, shard_tree, spawn
from zonos_tpu_torch.runtime import generate as TG
from zonos_tpu_torch.training import train as T

from .test_torch_parallel_training import _tree_like

FRAMES = 12
LR = 1e-3


def _tp4(cfg):
    """``cfg`` with 8 query and 4 KV heads (JAX's and the port's configs alike)."""
    bb = cfg.backbone
    attn = dataclasses.replace(bb.attn_cfg, num_heads=8, num_heads_kv=4)
    return dataclasses.replace(cfg, backbone=dataclasses.replace(bb, attn_cfg=attn))


# name: (port config, bits, int8 KV)
TP_CASES = {
    "transformer": (_tp4(tiny_transformer_config()), None, False),
    "transformer-int8": (_tp4(tiny_transformer_config()), 8, True),
    "transformer-int4": (_tp4(tiny_transformer_config(d_model=512)), 4, False),
    "hybrid": (_tp4(tiny_hybrid_config()), None, False),
    "hybrid-int8": (_tp4(tiny_hybrid_config()), 8, False),
}
DPTP_CASES = ("transformer", "hybrid")


def _params(name: str) -> dict:
    cfg, bits, _kv = TP_CASES[name]
    m = Zonos.from_config(cfg, seed=0, dtype=torch.float32, device="cpu")
    m = m.quantize(bits=bits) if bits else m
    return {k: m.params[k] for k in ("embeddings", "heads", "backbone")}


def _cond(d: int, b: int = 1, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(2 * b, 6, d)).astype(np.float32) * 0.5


def _batch(d: int):
    """4 rows of 16 frames, one masked after 5 (``finetune_lora``'s shapes, cut)."""
    rng = np.random.default_rng(0)
    cond = rng.normal(size=(4, 4, d)).astype(np.float32)
    codes = rng.integers(0, 1024, size=(4, 9, 16)).astype(np.int32)
    mask = np.ones((4, 15), bool)
    mask[0, 5:] = False
    return cond, codes, mask


def _train_case(mesh, name):
    """The dp 1 × tp 4 loss, gradients and 3 steps against one device's."""
    cfg = TP_CASES[name][0]
    params = _params(name)
    batch = _batch(cfg.backbone.d_model)
    leaves = T.trainable_leaves(params)
    loss1, g1 = T.value_and_grad(lambda c, d, m: T.loss_terms(params, cfg, c, d, m), leaves, 1, *batch)
    want = dict(T.named_leaves(shard_tree(cfg, _tree_like(params, g1), mesh.tp, mesh.tp_rank)))
    local = shard_params(mesh, cfg, params)
    lcfg = local_config(cfg, mesh.tp)
    local_batch = T.shard_batch(mesh, *batch)
    loss, g = T.sharded_value_and_grad(
        mesh, lambda c, d, m: T.loss_terms(local, lcfg, c, d, m, mesh=mesh), T.trainable_leaves(local), 1,
        *local_batch)
    paths = [p for p, t in T.named_leaves(local) if t.is_floating_point()]
    opt = T.make_optimizer(lr=LR, warmup=1)
    state, step = T.make_sharded_train_step(mesh, cfg, opt, params)
    ref_state, ref_step = T.init_train_state(copy.deepcopy(params), opt), T.build_train_step(cfg, opt)
    losses, ref_losses = [], []
    for _ in range(3):
        state, lo = step(state, *local_batch)
        ref_state, ref_lo = ref_step(ref_state, *batch)
        losses.append(float(lo))
        ref_losses.append(float(ref_lo))
    return {"loss": float(loss), "ref_loss": float(loss1),
            "grads": {p: (t.detach().numpy(), want[p].detach().numpy()) for p, t in zip(paths, g)},
            "losses": losses, "ref_losses": ref_losses}


def _rank_side(backend, device):
    """Every case on this rank: {case: results}."""
    torch.set_num_threads(1)
    out = {}
    tp = make_mesh(dp=1, tp=4, backend=backend, device=device)
    dptp = make_mesh(dp=2, tp=2, backend=backend, device=device)
    greedy = SamplingParams(temperature=0.0)
    with torch.no_grad():
        for name, (cfg, _bits, kv) in TP_CASES.items():
            local = shard_params(tp, cfg, _params(name))
            out[name] = TG.generate(local, cfg, _cond(cfg.backbone.d_model), mesh=tp, max_new_tokens=FRAMES,
                                    sampling_params=greedy, seed=4, dtype=torch.float32, kv_int8=kv)
        for name in DPTP_CASES:
            cfg = TP_CASES[name][0]
            params = _params(name)
            cond = _cond(cfg.backbone.d_model, b=4, seed=1)
            kw = dict(max_new_tokens=FRAMES, batch_size=4, seed=3, dtype=torch.float32, return_lengths=True)
            local = shard_params(dptp, cfg, params)
            out[f"dptp/{name}"] = {"codes": TG.generate(local, cfg, cond, mesh=dptp, **kw),
                                   "ref": TG.generate(params, cfg, cond, device="cpu", **kw) if tp.rank == 0 else None}
    for name in DPTP_CASES:
        out[f"train/{name}"] = _train_case(tp, name)
    return out


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return tuple(_numpy(v) for v in tree)  # JAX's groups are a tuple
    return None if tree is None else tree.numpy()


@pytest.fixture(scope="module")
def ranks():
    """(each rank's results, {case: JAX's one-device greedy codes})."""
    import jax.numpy as jnp

    from zonos_tpu.config import tiny_hybrid_config as j_hybrid
    from zonos_tpu.config import tiny_transformer_config as j_tiny
    from zonos_tpu.ops.sampling import SamplingParams as JSP
    from zonos_tpu.runtime import generate as JG

    jcfgs = {"transformer": _tp4(j_tiny()), "transformer-int8": _tp4(j_tiny()),
             "transformer-int4": _tp4(j_tiny(d_model=512)), "hybrid": _tp4(j_hybrid()),
             "hybrid-int8": _tp4(j_hybrid())}
    with ThreadPoolExecutor(1) as pool:
        group = pool.submit(spawn, _rank_side, 4, "gloo", "cpu", timeout=600)
        jax_codes = {
            name: JG.generate(_numpy(_params(name)), c, _cond(c.backbone.d_model), max_new_tokens=FRAMES,
                              sampling_params=JSP(temperature=0.0), seed=4, dtype=jnp.float32,
                              kv_int8=TP_CASES[name][2])
            for name, c in jcfgs.items()
        }
        return group.result(), jax_codes


@pytest.mark.parametrize("name", sorted(TP_CASES))
def test_tp4_greedy_codes_match_jax(ranks, name):
    results, jax_codes = ranks
    ref = jax_codes[name]
    assert ref.shape == (1, 9, FRAMES)
    assert len(results) == 4
    for r in results:  # all four tp ranks
        np.testing.assert_array_equal(r[name], ref)


@pytest.mark.parametrize("name", DPTP_CASES)
def test_dp2_tp2_codes_match_one_device(ranks, name):
    """Each dp index decodes 2 of the 4 rows on its 2 tp ranks; every rank
    returns all 4 rows, equal to one device's."""
    results, _ = ranks
    ref, ref_len = results[0][f"dptp/{name}"]["ref"]
    assert ref.shape == (4, 9, FRAMES)
    assert len({tuple(row.ravel()[:20]) for row in ref}) == 4  # rows differ
    for r in results:
        codes, lengths = r[f"dptp/{name}"]["codes"]
        np.testing.assert_array_equal(codes, ref)
        np.testing.assert_array_equal(lengths, ref_len)


@pytest.mark.parametrize("name", DPTP_CASES)
def test_tp4_train_step_matches_one_device(ranks, name):
    results, _ = ranks
    for r in results:
        res = r[f"train/{name}"]
        np.testing.assert_allclose(res["loss"], res["ref_loss"], rtol=1e-5)
        for path, (got, want) in res["grads"].items():
            assert got.shape == want.shape, path
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max(), err_msg=path)
        np.testing.assert_allclose(res["losses"], res["ref_losses"], rtol=1e-5)
        assert res["losses"][2] < res["losses"][0]  # the first step has lr 0, the third moved
        assert res["losses"] == results[0][f"train/{name}"]["losses"]  # one global loss on every rank
