"""Continuous batching in the port (``runtime/continuous.py``) against JAX's.

``join``, ``kill`` and ``roll`` are pure data movement: on the same bridged
carry they give JAX's leaves exactly (bf16 KV, head-major int8 KV, the
hybrid's cache). A request joined into a running batch gives the greedy
codes of its solo run, in the port and in JAX, also after a KV roll and on
the hybrid; sampled, it gives the port's solo run at the same seed; rows of
different sampling settings in one batch each give their own solo run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zonos_tpu.config import tiny_hybrid_config as j_tiny_hybrid
from zonos_tpu.config import tiny_transformer_config as j_tiny
from zonos_tpu.models.zonos import Zonos as JZonos
from zonos_tpu.ops.delay_pattern import apply_delay_pattern_np as j_delay
from zonos_tpu.ops.sampling import SamplingParams as JSP
from zonos_tpu.runtime import continuous as JC
from zonos_tpu.runtime import generate as JG
from zonos_tpu_torch.bridge import hybrid_cache_from_jax, params_from_jax
from zonos_tpu_torch.config import tiny_hybrid_config, tiny_transformer_config
from zonos_tpu_torch.models.transformer import KVCache
from zonos_tpu_torch.ops.delay_pattern import apply_delay_pattern_np
from zonos_tpu_torch.ops.sampling import RuntimeSamplingParams, SamplingParams
from zonos_tpu_torch.runtime import continuous as TC
from zonos_tpu_torch.runtime import generate as TG

GREEDY = dict(temperature=0.0, repetition_penalty=1.0)
MAX_NEW = 40
N_Q = 9


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, jcfg, tcfg in (("transformer", j_tiny(), tiny_transformer_config()),
                             ("hybrid", j_tiny_hybrid(), tiny_hybrid_config())):
        jm = JZonos.from_config(jcfg, seed=0, dtype=jnp.float32)
        out[name] = (jm, params_from_jax(jax.tree.map(np.asarray, jm.params)), tcfg)
    return out


def _cond(seed, lc=10, d=64):
    return (np.random.default_rng(seed).normal(size=(2, lc, d)) * 0.5).astype(np.float32)


def _statics(cfg, batch_size, kv_int8, sampling=None, runtime=True, lc=12):
    p = TG._bucket(lc + 1, 64)
    s = TG._bucket(MAX_NEW + N_Q, 512)
    return TG.GenerateStatics(cfg=cfg, sampling=sampling or SamplingParams(), prefill_len=p, delayed_len=s,
                              cache_len=TG._bucket(p + s, 128), batch_size=batch_size, kv_int8=kv_int8,
                              runtime_sampling=runtime)


# ---------------------------------------------------------------------------
# join / kill / roll leaf for leaf against JAX
# ---------------------------------------------------------------------------

def _t(a):
    return None if a is None else torch.from_numpy(np.array(a, copy=True))


def _port_carry(jc, hybrid):
    c = jc.cache
    cache = hybrid_cache_from_jax(jax.tree.map(np.asarray, c)) if hybrid else KVCache(
        k=_t(c.k), v=_t(c.v), k_scale=_t(c.k_scale), v_scale=_t(c.v_scale))
    b = int(jc.stopping.shape[0])
    return TG.DecodeCarry(delayed_codes=_t(jc.delayed_codes), offset=int(jc.offset), cache=cache,
                          stopping=_t(jc.stopping), remaining_steps=_t(jc.remaining_steps),
                          stop_offset=_t(jc.stop_offset), steps_done=int(jc.steps_done),
                          generators=[torch.Generator() for _ in range(b)])


def _cache_leaves(cache, hybrid):
    if hybrid:
        return [x for name in ("kv_k", "kv_v", "kv_ks", "kv_vs", "conv", "ssm") for x in getattr(cache, name)]
    return [cache.k, cache.v, cache.k_scale, cache.v_scale]


def _assert_carry_equal(jc, pc, hybrid):
    for name in ("delayed_codes", "stopping", "remaining_steps", "stop_offset"):
        np.testing.assert_array_equal(np.asarray(getattr(jc, name)), getattr(pc, name).numpy(), err_msg=name)
    assert int(jc.offset) == pc.offset and int(jc.steps_done) == pc.steps_done
    jl, pl = _cache_leaves(jc.cache, hybrid), _cache_leaves(pc.cache, hybrid)
    assert len(jl) == len(pl)
    for a, b in zip(jl, pl):
        if a is None:
            assert b is None
            continue
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("kind", ["bf16", "int8", "hybrid"])
def test_join_kill_roll_match_jax_leaf_for_leaf(models, kind):
    hybrid = kind == "hybrid"
    jm, _params, tcfg = models["hybrid" if hybrid else "transformer"]
    kv_int8 = kind != "bf16"
    jst = JG.GenerateStatics(cfg=jm.config, sampling=JSP(**GREEDY), prefill_len=64, delayed_len=512,
                             cache_len=640, batch_size=2, kv_int8=kv_int8)
    tst = _statics(tcfg, 2, kv_int8, runtime=False, sampling=SamplingParams(**GREEDY))
    start, segment, prefill_b1, join, kill = JC.compiled_continuous_fns(jst)
    a, b = _cond(1), _cond(2)
    cond = np.concatenate([a[:1], a[:1], a[1:], a[1:]])
    pad_a = 64 - 11
    delayed = jnp.asarray(j_delay(np.full((2, N_Q, 512 - N_Q), -1, np.int32), jm.config.masked_token_id))
    pad = jnp.full((4,), pad_a, jnp.int32)
    pos = gap = jnp.zeros((4,), jnp.int32)
    bc, _st, _ = start(jm.params, JG.pad_conditioning(cond, pad_a, jnp.float32), delayed, jnp.int32(1), pad,
                       jnp.float32(2.0), jax.random.key(0), jnp.int32(100), jnp.int32(0))
    bc = kill(bc, jnp.int32(1), jnp.int32(0))
    bc, _st, _ = segment(jm.params, bc, pad, jnp.float32(2.0), jnp.int32(100), jnp.int32(7), pos, gap)
    c1 = JC.compiled_continuous_fns(jst)[2](
        jm.params, JG.pad_conditioning(b, pad_a, jnp.float32), delayed[:1], jnp.int32(1),
        jnp.full((2,), pad_a, jnp.int32), jnp.float32(2.0), jax.random.key(1))
    pbc, pc1 = _port_carry(bc, hybrid), _port_carry(c1, hybrid)
    _assert_carry_equal(bc, pbc, hybrid)

    new_pad = jnp.asarray([pad_a - 1, pad_a - 2], jnp.int32)
    jb, jpos, jgap, jpad = join(bc, c1, jnp.int32(1), pos, gap, pad, new_pad)
    tpos = tgap = torch.zeros(4, dtype=torch.int32)
    pb, ppos, pgap, ppad = TC.build_join_fn(tst)(pbc, pc1, 1, tpos, tgap, torch.full((4,), pad_a, dtype=torch.int32),
                                                 [pad_a - 1, pad_a - 2])
    _assert_carry_equal(jb, pb, hybrid)
    for x, y in ((jpos, ppos), (jgap, pgap), (jpad, ppad)):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    assert pb.generators[1] is pc1.generators[0]

    jb = kill(jb, jnp.int32(0), jnp.int32(5))
    pb = TC.build_kill_fn(tst)(pb, 0, 5)
    _assert_carry_equal(jb, pb, hybrid)

    for m, r in ((3, None), (2, 4), (0, 0)):
        jb, jpos, jgap = JC.compiled_roll_fn(jst)(jb, jnp.int32(m), jpos, jgap,
                                                  None if r is None else jnp.int32(r))
        pb, ppos, pgap = TC.build_roll_fn(tst)(pb, m, ppos, pgap, r)
        _assert_carry_equal(jb, pb, hybrid)
        np.testing.assert_array_equal(np.asarray(jpos), ppos.numpy())
        np.testing.assert_array_equal(np.asarray(jgap), pgap.numpy())


# ---------------------------------------------------------------------------
# Joined requests against their solo runs
# ---------------------------------------------------------------------------

def _run_schedule(params, statics, reqs, roll_after=None, attend_len=None):
    """Drive the port's continuous runtime on the host, as the engine does:
    an all-dummy start, every request joining a free slot at its step,
    segments up to the next event, a budget-capped kill. ``reqs``: dicts of
    cond [2, Lc, D], seed, sampling, cfg, at. ``roll_after`` = (step, m):
    a KV roll after that step, then segments on the ``attend_len`` rung.
    Returns each request's codes in solo coordinates."""
    cfg = statics.cfg
    B, P, S = statics.batch_size, statics.prefill_len, statics.delayed_len
    start, segment, prefill_b1, join, kill = TC.compiled_continuous_fns(statics)
    delayed0 = torch.as_tensor(apply_delay_pattern_np(np.full((B, N_Q, S - N_Q), -1, np.int32),
                                                      cfg.masked_token_id))
    first = reqs[0]
    rt = RuntimeSamplingParams.from_static(SamplingParams(**first["sampling"]), B)
    cfg_vec = torch.full((B,), float(first["cfg"]))
    pad = torch.full((2 * B,), P - 1, dtype=torch.int32)
    pos = gap = torch.zeros(2 * B, dtype=torch.int32)
    bc, _status, _ = start(params, torch.zeros((2 * B, P, 64)), delayed0, 1, pad, cfg_vec,
                           TG.row_generators(first["seed"], B, "cpu"), 0, 0, rt_params=rt)
    for i in range(B):
        bc = kill(bc, i, 0)
    slot_of, shift, need, out, rolled = {}, {}, {}, {}, 0
    events = sorted({r["at"] for r in reqs} | {r["at"] + MAX_NEW + N_Q - 2 for r in reqs}
                    | ({roll_after[0]} if roll_after else set()))
    seg = segment
    for ev in events:
        if bc.steps_done + rolled < ev:
            bc, _status, _ = seg(params, bc, pad, cfg_vec, ev - rolled, ev - rolled, pos, gap, rt, early_exit=False)
        for k, r in enumerate(reqs):  # retire budgets reached, then join
            if k in slot_of and k not in out and need[k] <= ev:
                i = slot_of[k]
                end = int(bc.stop_offset[i]) if int(bc.stop_offset[i]) >= 0 else bc.offset
                row = torch.roll(bc.delayed_codes[i], -shift[k], dims=-1).numpy()
                out[k] = TG.postprocess_codes_batched(row[None], np.asarray([end - shift[k]]), cfg)[0][0]
                bc = kill(bc, i, bc.offset)
        busy = {slot_of[k] for k in slot_of if k not in out}
        for k, r in enumerate(reqs):
            if r["at"] == ev:
                i = min(set(range(B)) - busy)
                busy.add(i)
                lp = P - (r["cond"].shape[1] + 1)
                rt1 = RuntimeSamplingParams.from_static(SamplingParams(**r["sampling"]), 1)
                c1 = prefill_b1(params, TG.pad_conditioning(r["cond"], lp, torch.float32, "cpu"), delayed0[:1], 1,
                                torch.full((2,), lp, dtype=torch.int32), float(r["cfg"]),
                                TG.row_generators(r["seed"], 1, "cpu"), rt_params=rt1)
                shift[k] = bc.offset - c1.offset
                bc, pos, gap, pad = join(bc, c1, i, pos, gap, pad, [lp, lp])
                rt, cfg_vec = TC.compiled_set_sampling_row()(rt, cfg_vec, i, rt1, r["cfg"])
                slot_of[k], need[k] = i, ev + MAX_NEW + N_Q - 2
        if roll_after and ev == roll_after[0]:
            m = roll_after[1]
            bc, pos, gap = TC.compiled_roll_fn(statics)(bc, m, pos, gap)
            rolled += m
            seg = TC.compiled_segment_attend(statics, attend_len)
    return [out[k] for k in range(len(reqs))]


def _solo(params, cfg, r, kv_int8):
    return TG.generate(params, cfg, r["cond"], max_new_tokens=MAX_NEW, cfg_scale=r["cfg"],
                       sampling_params=r["sampling"], seed=r["seed"], dtype=torch.float32, kv_int8=kv_int8,
                       device="cpu")[0]


def _jax_solo(jm, r, kv_int8):
    return JG.generate(jm.params, jm.config, r["cond"], max_new_tokens=MAX_NEW, cfg_scale=r["cfg"],
                       sampling_params=JSP(**r["sampling"]), seed=r["seed"], dtype=jnp.float32,
                       kv_int8=kv_int8)[0]


@pytest.mark.parametrize("kind,roll", [("transformer-bf16", False), ("transformer-int8", False),
                                       ("transformer-int8", True), ("hybrid-int8", True)])
def test_joined_greedy_codes_equal_solo_port_and_jax(models, kind, roll):
    name, kv = kind.split("-")
    jm, params, tcfg = models[name]
    kv_int8 = kv == "int8"
    reqs = [dict(cond=_cond(1), seed=1, sampling=GREEDY, cfg=2.0, at=0),
            dict(cond=_cond(2, lc=12), seed=2, sampling=GREEDY, cfg=2.0, at=11)]
    statics = _statics(tcfg, 2, kv_int8)
    # The roll: request 0 retires at step 47; request 1's gap (11) then rolls out.
    got = _run_schedule(params, statics, reqs, roll_after=(47, 11) if roll else None,
                        attend_len=statics.prefill_len + 128)
    for k, r in enumerate(reqs):
        solo = _solo(params, tcfg, r, kv_int8)
        np.testing.assert_array_equal(got[k], solo)
        np.testing.assert_array_equal(solo, _jax_solo(jm, r, kv_int8))


def test_sampled_join_equals_port_solo_at_same_seed(models):
    _jm, params, tcfg = models["transformer"]
    reqs = [dict(cond=_cond(3), seed=5, sampling=dict(min_p=0.1), cfg=2.0, at=0),
            dict(cond=_cond(4), seed=9, sampling=dict(min_p=0.1), cfg=2.0, at=6)]
    got = _run_schedule(params, _statics(tcfg, 3, True), reqs)
    for k, r in enumerate(reqs):
        np.testing.assert_array_equal(got[k], _solo(params, tcfg, r, True))


def test_heterogeneous_sampling_in_one_batch(models):
    _jm, params, tcfg = models["transformer"]
    reqs = [dict(cond=_cond(5), seed=11, sampling=dict(min_p=0.1), cfg=2.0, at=0),
            dict(cond=_cond(6), seed=12, sampling=dict(top_p=0.8, temperature=0.7), cfg=3.0, at=0),
            dict(cond=_cond(7), seed=13, sampling=dict(linear=0.5, conf=0.2, quad=0.1, min_p=0.0,
                                                       repetition_penalty=1.0), cfg=1.5, at=4),
            dict(cond=_cond(8), seed=14, sampling=GREEDY, cfg=2.5, at=9)]
    got = _run_schedule(params, _statics(tcfg, 4, True), reqs)
    for k, r in enumerate(reqs):
        np.testing.assert_array_equal(got[k], _solo(params, tcfg, r, True), err_msg=str(r["sampling"]))


def test_per_request_seed_vector(models):
    """A batch started with one seed per row: each row draws its solo stream."""
    _jm, params, tcfg = models["transformer"]
    conds = [_cond(21), _cond(22)]
    statics = _statics(tcfg, 2, True)
    start = TC.compiled_continuous_fns(statics)[0]
    p = statics.prefill_len
    cond = np.concatenate([conds[0][:1], conds[1][:1], conds[0][1:], conds[1][1:]])
    lp = p - 11
    delayed0 = torch.as_tensor(apply_delay_pattern_np(np.full((2, N_Q, statics.delayed_len - N_Q), -1, np.int32),
                                                      tcfg.masked_token_id))
    rt = RuntimeSamplingParams.from_static(SamplingParams(min_p=0.1), 2)
    steps = MAX_NEW + N_Q - 2
    bc, status, _ = start(params, TG.pad_conditioning(cond, lp, torch.float32, "cpu"), delayed0, 1,
                          torch.full((4,), lp, dtype=torch.int32), 2.0, TG.row_generators([31, 32], 2, "cpu"),
                          steps, steps, rt_params=rt)
    stop = bc.stop_offset.numpy()
    out, _ = TG.postprocess_codes_batched(bc.delayed_codes.numpy(), np.where(stop >= 0, stop, bc.offset), tcfg)
    for i, seed in enumerate((31, 32)):
        solo = _solo(params, tcfg, dict(cond=conds[i], seed=seed, sampling=dict(min_p=0.1), cfg=2.0), True)
        np.testing.assert_array_equal(out[i][:, :solo.shape[-1]], solo)
        assert not out[i][:, solo.shape[-1]:].any()
