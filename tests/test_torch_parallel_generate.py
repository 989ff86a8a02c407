"""Sharded ``generate`` (``zonos_tpu_torch/runtime/generate.py`` with a
``parallel.mesh`` mesh) against the JAX package's one-device ``generate``
and the port's, on one group of 2 gloo ranks on the CPU.

The ranks are spawned once for the file (``ranks`` fixture) and run every
case's rank side while JAX runs its side in this process; each test asserts
on its part of the results. The models are the port's, from seed 0 (JAX's
``generate`` takes the same params as numpy). float32:

* tp = 2, greedy: the transformer (float, int8 weights with int8 KV, int4 at
  d 256) and the hybrid (float, int8): codes identical to JAX's one-device
  ``generate`` and to the port's, on both ranks; the first step's logits
  within 1e-4 relative of the port's one-device logits;
* tp = 2 at min-p 0.1 with a fixed seed: codes identical to the port's
  one-device run (torch cannot replay ``jax.random``, so sampling is held
  to the port);
* dp = 2, B 4 (transformer and hybrid) at one int seed: codes and lengths
  identical to the port's one-device run of all 4 rows;
* ``make_mesh`` refuses dp·tp != world and nccl without a card per rank.

The rank side imports no JAX: the ranks import this module afresh.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from zonos_tpu_torch.config import tiny_hybrid_config, tiny_transformer_config
from zonos_tpu_torch.models.backbone import backbone_forward
from zonos_tpu_torch.models.zonos import Zonos
from zonos_tpu_torch.ops.sampling import SamplingParams
from zonos_tpu_torch.parallel.mesh import local_config, make_mesh, shard_params, spawn
from zonos_tpu_torch.runtime import generate as TG

FRAMES = 12
# name: (port config, bits, int8 KV)
TP_CASES = {
    "transformer": (tiny_transformer_config(), None, False),
    "transformer-int8": (tiny_transformer_config(), 8, True),
    "transformer-int4": (tiny_transformer_config(d_model=256), 4, False),
    "hybrid": (tiny_hybrid_config(), None, False),
    "hybrid-int8": (tiny_hybrid_config(), 8, False),
}
DP_CASES = ("transformer", "hybrid")


def _params(name: str) -> dict:
    cfg, bits, _kv = TP_CASES[name]
    m = Zonos.from_config(cfg, seed=0, dtype=torch.float32, device="cpu")
    m = m.quantize(bits=bits) if bits else m
    return {k: m.params[k] for k in ("embeddings", "heads", "backbone")}


def _cond(d: int, b: int = 1, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(2 * b, 6, d)).astype(np.float32) * 0.5


def _first_logits(params, cfg, cond, mesh=None) -> np.ndarray:
    """The guided logits of the prefill's last position (no cache)."""
    x = torch.as_tensor(cond)
    pad = torch.zeros((x.shape[0],), dtype=torch.int32)
    h, _ = backbone_forward(params["backbone"], cfg.backbone, x, None, write_start=0, pad_amount=pad,
                            attend_len=x.shape[1], mesh=mesh)
    logits = TG.apply_heads(params["heads"], h[:, -1:], cfg.codebook_dimension)[:, :, 0]
    return TG._guide(logits, 2.0).numpy()


def _rank_side(backend, device):
    """Every case on this rank: {case: results}."""
    torch.set_num_threads(1)
    out = {}
    tp = make_mesh(dp=1, tp=2, backend=backend, device=device)
    greedy = SamplingParams(temperature=0.0)
    with torch.no_grad():
        for name, (cfg, _bits, kv) in TP_CASES.items():
            params = _params(name)
            cond = _cond(cfg.backbone.d_model)
            kw = dict(max_new_tokens=FRAMES, sampling_params=greedy, seed=4, dtype=torch.float32, kv_int8=kv)
            local = shard_params(tp, cfg, params)
            out[name] = {
                "codes": TG.generate(local, cfg, cond, mesh=tp, **kw),
                "ref": TG.generate(params, cfg, cond, device="cpu", **kw),
                "logits": _first_logits(local, local_config(cfg, 2), cond, tp),
                "ref_logits": _first_logits(params, cfg, cond),
            }
            if name == "transformer":
                kw["sampling_params"] = SamplingParams(min_p=0.1)
                out["min_p"] = {"codes": TG.generate(local, cfg, cond, mesh=tp, **kw),
                                "ref": TG.generate(params, cfg, cond, device="cpu", **kw)}
        dp = make_mesh(dp=2, tp=1, backend=backend, device=device)
        for name in DP_CASES:
            cfg = TP_CASES[name][0]
            params = _params(name)
            cond = _cond(cfg.backbone.d_model, b=4, seed=1)
            kw = dict(max_new_tokens=FRAMES, batch_size=4, seed=3, dtype=torch.float32, return_lengths=True)
            out[f"dp/{name}"] = {"codes": TG.generate(params, cfg, cond, mesh=dp, **kw),
                                 "ref": TG.generate(params, cfg, cond, device="cpu", **kw)}
    for case, kw in (("dp*tp", dict(dp=2, tp=2, backend=backend, device=device)),
                     ("nccl", dict(dp=1, tp=2, backend="nccl", device="cpu"))):
        try:
            make_mesh(**kw)
            out[f"refused/{case}"] = None
        except ValueError as e:
            out[f"refused/{case}"] = str(e)
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

    jcfgs = {"transformer": j_tiny(), "transformer-int8": j_tiny(), "transformer-int4": j_tiny(d_model=256),
             "hybrid": j_hybrid(), "hybrid-int8": j_hybrid()}
    with ThreadPoolExecutor(1) as pool:
        group = pool.submit(spawn, _rank_side, 2, "gloo", "cpu", timeout=600)
        jax_codes = {
            name: JG.generate(_numpy(_params(name)), c, _cond(c.backbone.d_model), max_new_tokens=FRAMES,
                              sampling_params=JSP(temperature=0.0), seed=4, dtype=jnp.float32,
                              kv_int8=TP_CASES[name][2])
            for name, c in jcfgs.items()
        }
        return group.result(), jax_codes


@pytest.mark.parametrize("name", sorted(TP_CASES))
def test_tp_greedy_codes_match_jax(ranks, name):
    results, jax_codes = ranks
    ref = jax_codes[name]
    assert ref.shape == (1, 9, FRAMES)
    np.testing.assert_array_equal(results[0][name]["ref"], ref)  # the port's one-device run
    for r in results:  # both tp ranks
        np.testing.assert_array_equal(r[name]["codes"], ref)


@pytest.mark.parametrize("name", sorted(TP_CASES))
def test_tp_first_step_logits_match_one_device(ranks, name):
    results, _ = ranks
    for r in results:
        got, want = r[name]["logits"], r[name]["ref_logits"]
        assert got.shape == want.shape == (1, 9, 1025)
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), name
    np.testing.assert_array_equal(results[0][name]["logits"], results[1][name]["logits"])


def test_tp_min_p_codes_match_one_device(ranks):
    results, _ = ranks
    ref = results[0]["min_p"]["ref"]
    assert ref.shape == (1, 9, FRAMES)
    for r in results:
        np.testing.assert_array_equal(r["min_p"]["codes"], ref)


@pytest.mark.parametrize("name", DP_CASES)
def test_dp_codes_match_one_device(ranks, name):
    """Each dp rank decodes 2 of the 4 rows (its rows of each CFG half, with
    its global rows' seeds); every rank returns all 4 rows."""
    results, _ = ranks
    ref, ref_len = results[0][f"dp/{name}"]["ref"]
    assert ref.shape == (4, 9, FRAMES)
    assert len({tuple(row.ravel()[:20]) for row in ref}) == 4  # rows differ: each draws its own stream
    for r in results:
        codes, lengths = r[f"dp/{name}"]["codes"]
        np.testing.assert_array_equal(codes, ref)
        np.testing.assert_array_equal(lengths, ref_len)


@pytest.mark.parametrize("case,match", [("dp*tp", r"dp\(2\) \* tp\(2\) != 2 ranks"),
                                        ("nccl", "nccl needs one card per rank")])
def test_make_mesh_refuses(ranks, case, match):
    import re

    results, _ = ranks
    for r in results:
        assert r[f"refused/{case}"] is not None and re.search(match, r[f"refused/{case}"]), r[f"refused/{case}"]
