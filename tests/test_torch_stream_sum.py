"""The plain versions of the streaming probes K5/K6 against XLA's int32 sum.

``jnp.sum(w, dtype=jnp.int32)`` is the baseline the Pallas probes of
tools/bench_stream.py are measured against; int32 addition wraps, in any
order, to the same bits, so the comparison is exact. The kernels themselves
run only on the card, where chip_smoke.py holds them to these versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zonos_tpu_torch.ops import stream_sum as S


@pytest.mark.parametrize("blk", [8, 16])
@pytest.mark.parametrize("fn", ["grid_sum_once", "manual_sum_once", "stream_sum_plain"])
def test_small_sum_exact(fn, blk):
    w = np.random.default_rng(blk).integers(-127, 127, size=(64, 256), dtype=np.int8)
    ref = int(jnp.sum(jnp.asarray(w), dtype=jnp.int32))
    before = (S.grid_sum_once.launches, S.manual_sum_once.launches)
    got = getattr(S, fn)(torch.from_numpy(w), blk)
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(got) == ref
    assert (S.grid_sum_once.launches, S.manual_sum_once.launches) == before  # no kernel on the CPU


def test_sum_wraps_past_int32_like_xla():
    w = np.full((4096, 4352), 127, dtype=np.int8)  # 2,263,875,584 > 2**31 - 1
    ref = int(jnp.sum(jnp.asarray(w), dtype=jnp.int32))
    assert ref == 2_263_875_584 - 2**32
    for fn in (S.grid_sum_once, S.manual_sum_once, S.stream_sum_plain):
        assert int(fn(torch.from_numpy(w), 512)) == ref
    assert int(torch.sum(torch.from_numpy(w), dtype=torch.int32)) == ref


@pytest.mark.parametrize("shape,blk", [((64, 256), 7), ((64,), 8)])
def test_rejects_what_the_kernels_do_not_take(shape, blk):
    w = torch.zeros(shape, dtype=torch.int8)
    with pytest.raises(ValueError):
        S.grid_sum_once(w, blk)


def test_manual_stage_is_one_chunk_capped_to_a_ring_slot():
    assert S.manual_stage_bytes(8, 256) == 2048
    assert S.manual_stage_bytes(512, 8192) == S.STAGE_BYTES_MAX == 65536
