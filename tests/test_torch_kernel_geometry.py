"""Launch geometry of the cluster kernels K1-K4, and the padded int8 heads.

The CUDA kernels split their work on the card by formulas that the wrappers
mirror in Python (``attn_shares`` / ``attn_stages`` for K2,
``int8_rank_stages`` for K1 and K3's fc2, ``int4_rank_groups`` for K4,
``fused_mlp_columns`` / ``fused_mlp_stages`` for K3's fc1): every cache slot,
K row, int4 group and F column must be taken exactly once, no group may
straddle two ranks, the clusters must stay within the hardware's limit and the
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


# K4 at the four main-path projections (group 128) and at the tiny config's
# shapes (group min(128, K)).
K4_SHAPES = [(2048, 3072, 128), (2048, 2048, 128), (2048, 16384, 128), (8192, 2048, 128),
             (64, 128, 64), (64, 256, 64), (128, 64, 128), (256, 192, 128)]
SOME_B = [1, 2, 3, 8, 16]


@pytest.mark.parametrize("b", SOME_B)
@pytest.mark.parametrize("k,n,group", K4_SHAPES)
def test_k4_ranks_take_each_group_and_packed_row_once(k, n, group, b):
    plan = TM.int4_matmul_plan(b, k, n, group)
    g, half = k // group, group // 2
    assert 1 <= plan.cluster <= TM.MAX_CLUSTER and plan.cluster <= max(g, 1)
    assert plan.per * plan.cluster >= TM.K4_COLS
    assert 1 <= plan.slots <= TM.K4_RING_SLOTS and plan.smem_bytes <= MAX_SMEM, plan
    ranks = TM.int4_rank_groups(k, group, plan)
    assert len(ranks) == plan.cluster and all(0 <= count <= plan.gpr for _, count in ranks)
    assert _covered_once(ranks, 0, g)
    # the ring's stages: one group, group/2 packed rows, each
    packed = [((first + st) * half, half) for first, count in ranks for st in range(count)]
    assert _covered_once(packed, 0, k // 2)
    # no group straddles two ranks: each K row's rank is its group's rank
    owner = np.full(k, -1)
    for r, (first, count) in enumerate(ranks):
        owner[first * group:(first + count) * group] = r
    assert (owner >= 0).all() and all(len(set(owner[i * group:(i + 1) * group])) == 1 for i in range(g))


@pytest.mark.parametrize("k,n", [(2048, 3072), (2048, 2048), (2048, 16384), (8192, 2048)])
def test_k4_plan_at_the_main_path_shapes(k, n):
    """Every B from 1 to 16 in one pass within 227 KB; at B 2 the grid is one
    wave on the 132 SMs of an H100 and fills at least 70% of them."""
    for b in range(1, 17):
        plan = TM.int4_matmul_plan(b, k, n, 128)
        assert plan.smem_bytes <= MAX_SMEM, (b, plan)
        assert plan.cluster * plan.gpr * 128 >= k
    plan = TM.int4_matmul_plan(2, k, n, 128)
    assert TM.H100_SMS * 0.7 <= plan.cluster * -(-n // TM.K4_COLS) <= TM.H100_SMS


# K3 at the flagship MLP (D 2048, F 8192) and at tiny widths
K3_SHAPES = [(2048, 8192, 2048), (64, 128, 64), (128, 256, 128), (256, 96, 256)]


@pytest.mark.parametrize("b", SOME_B)
@pytest.mark.parametrize("d,f,d_out", K3_SHAPES)
def test_k3_blocks_take_each_f_column_and_row_once(d, f, d_out, b):
    plan = TM.fused_mlp_plan(b, d, f, d_out)
    cols = TM.fused_mlp_columns(f, plan)
    assert len(cols) == plan.blocks and plan.blocks % TM.K3_RANKS == 0
    assert all(0 <= count <= TM.K3_COLS // TM.K3_RANKS for _, count in cols)
    assert _covered_once(cols, 0, f)  # y's columns, and the same of the gate
    # every fc1 cluster's ranks walk all D rows between them, in ring stages
    stages = TM.fused_mlp_stages(d)
    assert len(stages) == TM.K3_RANKS
    pieces = [p for rank in stages for p in rank]
    assert all(0 < count <= TM.K3_SLOT_ROWS for _, count in pieces) and _covered_once(pieces, 0, d)
    assert 1 <= plan.fc1_slots <= TM.K3_RING_SLOTS
    # fc2: K1's ranks over F rows, each rank's stages within its ring
    assert 1 <= plan.fc2.cluster <= TM.MAX_CLUSTER and plan.fc2.slots <= TM.K3_FC2_RING_SLOTS
    pieces = [p for rank in TM.int8_rank_stages(f, plan.fc2) for p in rank]
    assert _covered_once(pieces, 0, f)
    assert plan.fc1_smem_bytes <= MAX_SMEM and plan.fc2.smem_bytes <= MAX_SMEM, plan


def test_k3_plan_at_the_main_path_shape():
    """Every B from 1 to 16 within 227 KB; fc1's 128 blocks are one wave on
    an H100, and up to B 4 an fc1 block and an fc2 block fit one SM together
    (so that fc2's weight copies overlap fc1)."""
    for b in range(1, 17):
        plan = TM.fused_mlp_plan(b, 2048, 8192, 2048)
        assert max(plan.fc1_smem_bytes, plan.fc2.smem_bytes) <= MAX_SMEM, (b, plan)
        together = plan.fc1_smem_bytes + plan.fc2.smem_bytes + 2 * TM.SMEM_RESERVED_BYTES
        assert (together <= TM.SM_SMEM_BYTES) == (b <= TM.K3_SHARED_ROWS), (b, plan)
    plan = TM.fused_mlp_plan(2, 2048, 8192, 2048)
    assert plan.blocks == 128 <= TM.H100_SMS and plan.fc2.cluster * 8 == 128


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


# The hybrid's decode shapes (Zonos-v0.1-hybrid: Mamba in_proj 2048 → 8512,
# out_proj 4096 → 2048, Mamba-layer MLP of F 4096): N = 8512 leaves a
# 64-column tail after 33 tiles of 256.
HYBRID_K1 = [(2048, 8512), (4096, 2048)]
HYBRID_K4 = [(2048, 8512), (4096, 2048), (2048, 8192)]  # in_proj, out_proj and fc2, fc1 at F 4096


def _tile_columns(n, tile, cluster, per):
    """(first column, count) each rank of each tile reduces."""
    return [(t * tile + r * per, max(0, min(per, tile - r * per, n - t * tile - r * per)))
            for t in range(-(-n // tile)) for r in range(cluster)]


@pytest.mark.parametrize("k,n", HYBRID_K1)
def test_k1_plan_at_the_hybrid_shapes(k, n):
    for b in range(1, 17):
        plan = TM.int8_matmul_plan(b, k, n)
        assert 1 <= plan.cluster <= TM.MAX_CLUSTER and plan.smem_bytes <= MAX_SMEM, (b, plan)
        assert _covered_once([p for rank in TM.int8_rank_stages(k, plan) for p in rank], 0, k)
        cols = _tile_columns(n, TM.K1_COLS, plan.cluster, plan.per)
        assert _covered_once(cols, 0, n)
    if n % TM.K1_COLS:  # the tail tile: its last rank with columns ends at n
        tail = [c for c in _tile_columns(n, TM.K1_COLS, TM.int8_matmul_plan(2, k, n).cluster,
                                         TM.int8_matmul_plan(2, k, n).per) if c[0] >= (n // TM.K1_COLS) * 256]
        assert sum(count for _, count in tail) == n % TM.K1_COLS == 64


@pytest.mark.parametrize("k,n", HYBRID_K4)
def test_k4_plan_at_the_hybrid_shapes(k, n):
    assert n % 16 == 0  # K4's tensor map of the packed [K/2, N] view
    for b in range(1, 17):
        plan = TM.int4_matmul_plan(b, k, n, 128)
        assert 1 <= plan.cluster <= TM.MAX_CLUSTER and plan.smem_bytes <= MAX_SMEM, (b, plan)
        assert _covered_once(TM.int4_rank_groups(k, 128, plan), 0, k // 128)
        assert _covered_once(_tile_columns(n, TM.K4_COLS, plan.cluster, plan.per), 0, n)
        assert plan.cluster * -(-n // TM.K4_COLS) <= TM.H100_SMS or plan.cluster == 1


def test_k3_plan_at_the_hybrid_mamba_mlp():
    """D 2048, F 4096: every F column and D row once, fc2 over the 4096 rows
    of h, within 227 KB for every B from 1 to 16."""
    d, f = 2048, 4096
    for b in range(1, 17):
        plan = TM.fused_mlp_plan(b, d, f, d)
        assert max(plan.fc1_smem_bytes, plan.fc2.smem_bytes) <= MAX_SMEM, (b, plan)
        assert _covered_once(TM.fused_mlp_columns(f, plan), 0, f)
        assert _covered_once([p for rank in TM.int8_rank_stages(f, plan.fc2) for p in rank], 0, f)
        assert 1 <= plan.fc2.cluster <= TM.MAX_CLUSTER
    assert TM.fused_mlp_plan(2, d, f, d).blocks == 64


def test_stacked_layer_views_stay_16_byte_aligned():
    """A layer of a stacked Mamba run is a view into the run's buffer: its
    base must stay 16-byte aligned for the kernels' tensor maps, int8 and
    packed int4 (the hybrid's runs are up to 5 layers long)."""
    from zonos_tpu_torch.ops.quant import quantize_int4

    for k, n in ((2048, 8512), (4096, 2048)):
        q = torch.zeros((5, k, n), dtype=torch.int8)
        assert all(q[i].data_ptr() % 16 == 0 and q[i].stride(0) % 16 == 0 for i in range(5))
        w4 = quantize_int4(torch.zeros((2, k, n)))
        assert w4["q4"].shape == (2, k // 128, 64, n)
        assert all(w4["q4"][i].data_ptr() % 16 == 0 and w4["q4"][i].is_contiguous() for i in range(2))
        assert all(w4["s4"][i].data_ptr() % 16 == 0 for i in range(2))
