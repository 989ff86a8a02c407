"""Launch geometry of the cluster kernels K1 and K2, and the padded int8 heads.

The CUDA kernels split their work on the card by formulas that the wrappers
mirror in Python (``attn_shares`` / ``attn_stages`` for K2,
``int8_rank_stages`` for K1): every cache slot and every K row must be taken
exactly once, the clusters must stay within the hardware's limit and the
shared-memory plans within the 227 KB a block may use on an H100. The int8
heads are stored with rows padded to 16 bytes so that K1 reads them by TMA;
logits and greedy codes must not change for it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zonos_tpu.config import tiny_transformer_config as j_tiny
from zonos_tpu.models.zonos import Zonos as JZonos
from zonos_tpu.ops.sampling import SamplingParams as JSP
from zonos_tpu.runtime import generate as JG
from zonos_tpu_torch.bridge import params_from_jax
from zonos_tpu_torch.config import tiny_transformer_config
from zonos_tpu_torch.models.zonos import Zonos
from zonos_tpu_torch.ops import cuda_attention as TA
from zonos_tpu_torch.ops import cuda_matmul as TM
from zonos_tpu_torch.ops.quant import pad_rows16, quantize_int8
from zonos_tpu_torch.ops.sampling import SamplingParams
from zonos_tpu_torch.runtime import generate as TG

MAX_SMEM = 227 * 1024


def _covered_once(pieces, lo, hi):
    seen = np.zeros(max(hi, 1), np.int32)
    for first, count in pieces:
        seen[first:first + count] += 1
    return bool((seen[lo:hi] == 1).all() and (seen[:lo] == 0).all())


@pytest.mark.parametrize("cache_len,pad", [(1152, 0), (1152, 37), (2816, 5), (4096, 0)])
def test_k2_shares_and_stages_cover_each_slot_once(cache_len, pad):
    """Every attend window 1..cache_len: the ranks' shares, walked in bulk-copy
    stages, take each valid slot once; no share exceeds the plan's share_cap."""
    plan = TA.attn_plan(cache_len, 4)
    for hi in range(pad + 1, cache_len + 1):
        shares = TA.attn_shares(pad, hi, plan.cluster)
        assert len(shares) == plan.cluster
        assert all(count <= plan.share_cap for _, count in shares)
        pieces = [(first + j0, n) for first, count in shares for j0, n in TA.attn_stages(count, plan.stage)]
        assert all(n <= plan.stage for _, n in pieces)
        assert _covered_once(pieces, pad, hi), (cache_len, pad, hi)


def test_k2_empty_window_takes_no_slot():
    assert all(count == 0 for _, count in TA.attn_shares(11, 11, TA.CLUSTER))
    assert all(count == 0 for _, count in TA.attn_shares(20, 5, TA.CLUSTER))


@pytest.mark.parametrize("g", [1, 2, 3, 4, 8])
def test_k2_plan_fits_shared_memory_and_cluster_limit(g):
    for s in range(1, 4097):
        plan = TA.attn_plan(s, g)
        assert 1 <= plan.cluster <= TA.MAX_CLUSTER
        assert plan.share_cap * plan.cluster >= s and plan.stage <= plan.share_cap
        assert plan.smem_bytes <= MAX_SMEM, (s, g, plan)


@pytest.mark.parametrize("k", [64, 2048, 8192])
@pytest.mark.parametrize("n", [16, 2048, 3072, 9225])
@pytest.mark.parametrize("b", [1, 2, 16])
def test_k1_rank_stages_cover_each_k_row_once(k, n, b):
    plan = TM.int8_matmul_plan(b, k, n)
    assert 1 <= plan.cluster <= TM.MAX_CLUSTER
    assert plan.cluster * plan.kc >= k
    assert plan.per * plan.cluster >= TM.K1_COLS
    stages = TM.int8_rank_stages(k, plan)
    pieces = [p for rank in stages for p in rank]
    assert all(0 < n_rows <= TM.K1_SLOT_ROWS for _, n_rows in pieces)
    assert _covered_once(pieces, 0, k)
    assert plan.smem_bytes <= MAX_SMEM, plan


def test_k1_plan_at_the_main_path_shapes():
    """in_proj, out_proj and the heads at the decode batch fill the 132 SMs of
    an H100 in one wave, and every B up to 16 fits shared memory."""
    for k, n in ((2048, 3072), (2048, 2048), (2048, 9225)):
        plan = TM.int8_matmul_plan(2, k, n)
        assert plan.cluster * -(-n // TM.K1_COLS) >= TM.H100_SMS * 0.9
        for b in range(1, 17):
            assert TM.int8_matmul_plan(b, k, n).smem_bytes <= MAX_SMEM


@pytest.mark.parametrize("n", [16, 130, 9225])
def test_pad_rows16_keeps_values_and_pads_the_stride(n):
    q = torch.randint(-127, 128, (24, n), dtype=torch.int8)
    p = pad_rows16(q)
    assert p.shape == q.shape and p.stride(1) == 1 and p.stride(0) % 16 == 0 and p.stride(0) - n < 16
    assert torch.equal(p, q)
    assert TM.int8_vector_path(p)
    x = torch.randn(2, 24)
    s = torch.rand(n) + 0.5
    torch.testing.assert_close(TM.int8_matmul(x, p, s), TM.int8_matmul_plain(x, q, s), rtol=0, atol=0)


def test_port_quantize_pads_the_int8_heads():
    model = Zonos.from_config(tiny_transformer_config(), seed=0, dtype=torch.float32, device="cpu")
    heads = model.quantize().params["heads"]
    ref = quantize_int8(model.params["heads"])
    assert heads["q"].shape == (64, 9 * 1025) and heads["q"].stride(0) % 16 == 0 and heads["q"].stride(1) == 1
    assert torch.equal(heads["q"], ref["q"]) and torch.equal(heads["s"], ref["s"])


@pytest.fixture(scope="module")
def bridged_int8():
    m = JZonos.from_config(j_tiny(), seed=0, dtype=jnp.float32).quantize()
    sub = {k: m.params[k] for k in ("embeddings", "heads", "backbone")}
    return m.params, params_from_jax(jax.tree.map(np.asarray, sub))


def test_bridged_heads_padded_give_jax_logits(bridged_int8):
    jparams, tparams = bridged_int8
    q = tparams["heads"]["q"]
    assert q.shape == tuple(jparams["heads"]["q"].shape) and q.stride(0) % 16 == 0 and q.stride(0) > q.shape[1]
    np.testing.assert_array_equal(q.numpy(), np.asarray(jparams["heads"]["q"]))
    hidden = np.random.default_rng(5).normal(size=(2, 1, 64)).astype(np.float32)
    ref = np.asarray(JG.apply_heads(jparams["heads"], jnp.asarray(hidden), 9))
    got = TG.apply_heads(tparams["heads"], torch.from_numpy(hidden), 9).numpy()
    # int8 x f32 products, f32 sums in another order: 1e-5 of the logits' scale
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_bridged_heads_padded_greedy_codes_match_jax(bridged_int8):
    jparams, tparams = bridged_int8
    cond = np.random.default_rng(6).normal(size=(2, 7, 64)).astype(np.float32) * 0.1
    ref = JG.generate(jparams, j_tiny(), cond, max_new_tokens=16, batch_size=1, sampling_params=JSP(temperature=0.0),
                      seed=0, dtype=jnp.float32, kv_int8=True)
    got = TG.generate(tparams, tiny_transformer_config(), cond, max_new_tokens=16, batch_size=1,
                      sampling_params=SamplingParams(temperature=0.0), seed=0, dtype=torch.float32, kv_int8=True,
                      device="cpu")
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
