"""The roofline counts against the kernel table's bounds (PERF.md)."""

import json

import pytest

from benchmark import roofline, spec


def us(fb):
    return roofline.least_s(*fb) * 1e6


@pytest.mark.parametrize("fb, bound_us", [
    (roofline.k1(2, 2048, 3072), 1.89),
    (roofline.k1(2, 2048, 2048), 1.26),
    (roofline.k1(2, 2048, 9225), 5.68),
    (roofline.k1(16, 2048, 9225), 5.85),
    (roofline.k1(32, 2048, 3072), 2.04),
    (roofline.k1(2, 2048, 8512), 5.24),
    (roofline.k1(2, 4096, 2048), 2.52),
    (roofline.k3(2, 2048, 8192), 15.05),
    (roofline.k3(32, 2048, 8192), 15.16),
    (roofline.k3(2, 2048, 4096), 7.53),
])
def test_kernel_bounds(fb, bound_us):
    assert us(fb) == pytest.approx(bound_us, abs=0.006)


def test_step_calls_and_least_time():
    bench = spec.load()
    tfm = json.load(open(spec.config_path(bench, "zonos-v0.1-transformer.int8")))["config"]
    # A Mamba2 hybrid: 24 layers, attention (MLP 8192) at 4 of them, the rest Mamba2 with MLP 4096.
    hyb = {"backbone": {"d_model": 2048, "n_layer": 24, "attn_layer_idx": [3, 9, 15, 21], "d_intermediate": 4096,
                        "attn_mlp_d_intermediate": 8192, "ssm_cfg": {"expand": 2, "d_state": 128, "ngroups": 1,
                                                                      "headdim": 64},
                        "attn_cfg": {"num_heads": 16, "num_heads_kv": 4}},
           "codebook_dimension": 9, "eos_token_id": 1024}
    calls = roofline.step_calls(tfm, 32)
    assert sum(k == "k1" for k, _ in calls) == 49 and sum(k == "k3" for k, _ in calls) == 24
    calls = roofline.step_calls(hyb, 32)
    assert sum(k == "k1" for k, _ in calls) == 49 and sum(k == "k3" for k, _ in calls) == 24
    # Bytes-bound at decode rows: ~1.5 GB of int8 weights per step → ~0.45 ms.
    assert 0.40e-3 < roofline.step_least_s(tfm, 32) < 0.50e-3
    assert roofline.step_least_s(tfm, 32) >= roofline.kernels_least_s(tfm, 32) * 0.99
