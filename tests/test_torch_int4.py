"""The port's int4 weights against the JAX package's.

Packing and scales bit for bit, the prefill product and K4's plain version
against JAX's XLA path at float32, K4's plain version against the Pallas
kernel in interpret mode, greedy int4 generation code for code, and the
bridge's dtypes for an int4 bf16 model. The CUDA kernel K4 itself is checked
on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zonos_tpu.config import tiny_transformer_config as j_tiny
from zonos_tpu.models.zonos import Zonos as JZonos
from zonos_tpu.ops import quant as JQ
from zonos_tpu.ops.pallas_matmul import int4_matmul as j_int4_matmul
from zonos_tpu.runtime import generate as JG
from zonos_tpu_torch.bridge import params_from_jax
from zonos_tpu_torch.config import tiny_transformer_config
from zonos_tpu_torch.models.zonos import Zonos
from zonos_tpu_torch.ops import cuda_matmul as TM
from zonos_tpu_torch.ops import quant as TQ
from zonos_tpu_torch.ops.sampling import SamplingParams


def _t(a):
    return torch.from_numpy(np.array(a))


def _quant_pair(k, n, lead=()):
    w = np.random.default_rng(k + n).normal(size=(*lead, k, n)).astype(np.float32)
    w[..., 3] = 0.0  # an all-zero output channel takes scale 1
    return w, JQ.quantize_int4(jnp.asarray(w)), TQ.quantize_int4(_t(w))


@pytest.mark.parametrize("k,n,lead", [(256, 96, (2,)), (64, 40, ())])  # group 128, and group = K = 64
def test_quantize_int4_bit_exact(k, n, lead):
    _, ref, got = _quant_pair(k, n, lead)
    assert got["q4"].dtype == torch.uint8 and got["s4"].dtype == torch.float32
    np.testing.assert_array_equal(got["q4"].numpy(), np.asarray(ref["q4"]))
    np.testing.assert_allclose(got["s4"].numpy(), np.asarray(ref["s4"]), rtol=1e-7, atol=0)
    vals = TM.unpack_nibbles(got["q4"], torch.float32).numpy()
    np.testing.assert_array_equal(vals, np.asarray(JQ._unpack_nibbles(ref["q4"], jnp.float32)))


@pytest.mark.parametrize("path", ["prefill", "k4_plain"])
@pytest.mark.parametrize("k,n", [(256, 96), (64, 40)])
def test_int4_products_match_xla_fp32(path, k, n):
    _, ref_w, got_w = _quant_pair(k, n)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 5, k) if path == "prefill" else (3, k)).astype(np.float32)
    ref = np.asarray(JQ.q4einsum_lastdim(jnp.asarray(x), ref_w))
    if path == "prefill":
        got = TQ.q4einsum_lastdim(_t(x), got_w).numpy()
    else:
        got = TM.int4_matmul_plain(_t(x), got_w["q4"], got_w["s4"]).numpy()
    # the same exact products and per-group f32 scaling; only the sums' order differs
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_k4_plain_matches_pallas_int4_matmul():
    b, k, n, group = 2, 256, 256, 128
    rng = np.random.default_rng(0)
    x = rng.normal(size=(b, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    q = JQ.quantize_int4(jnp.asarray(w), group=group)
    ref = np.asarray(j_int4_matmul(jnp.asarray(x), q["q4"], q["s4"], group=group, block_n=128, interpret=True))
    got = TM.int4_matmul(_t(x), _t(q["q4"]), _t(q["s4"])).numpy()
    # The TPU kernel rounds x and the dequantized weight to bf16 before its dot;
    # the port scales the exact per-group f32 sum: the JAX test's own bar.
    rel = np.abs(got - ref) / (np.abs(ref) + 1e-2)
    assert np.median(rel) < 1e-2, np.median(rel)


def test_decode_shaped_int4_takes_k4_wrapper_without_a_launch():
    _, _, w = _quant_pair(64, 40)
    x = torch.randn(2, 1, 64, generator=torch.Generator().manual_seed(0))
    before = TM.int4_matmul.launches
    y = TQ.qeinsum("bsd,de->bse", x, w)
    ref = TM.int4_matmul_plain(x[:, 0], w["q4"], w["s4"])[:, None]
    assert y.shape == (2, 1, 40) and torch.equal(y, ref)
    assert TM.int4_matmul.launches == before  # CPU tensors run the plain version, no kernel


@pytest.fixture(scope="module")
def int4_models():
    m = JZonos.from_config(j_tiny(), seed=0, dtype=jnp.float32).quantize(bits=4)
    port = Zonos(tiny_transformer_config(), params_from_jax(jax.tree.map(np.asarray, m.params)),
                 dtype=torch.float32, device="cpu")
    port.default_kv_int8 = True
    return m, port


@pytest.mark.parametrize("b", [1, 2])
def test_greedy_int4_codes_identical(int4_models, b):
    jm, port = int4_models
    cond = np.random.default_rng(b).normal(size=(2 * b, 10, 64)).astype(np.float32) * 0.5
    ref, ref_len = JG.generate(jm.params, jm.config, cond, max_new_tokens=24, batch_size=b,
                               sampling_params={"temperature": 0.0}, seed=0, dtype=jnp.float32, kv_int8=True,
                               return_lengths=True)
    got, got_len = port.generate(cond, max_new_tokens=24, batch_size=b, seed=0, return_lengths=True,
                                 sampling_params=SamplingParams(temperature=0.0))
    assert got.shape == ref.shape == (b, 9, 24)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got_len, ref_len)


def test_port_quantize_bits4_matches_jax_layout():
    """The port's own quantize(bits=4) gives the JAX layout: int4 backbone, int8 heads."""
    model = Zonos.from_config(tiny_transformer_config(), seed=0, dtype=torch.float32, device="cpu").quantize(bits=4)
    attn, mlp = model.params["backbone"]["layers"]["attn"], model.params["backbone"]["layers"]["mlp"]
    assert attn["in_proj"]["q4"].shape == (2, 1, 32, 128) and attn["in_proj"]["s4"].shape == (2, 1, 1, 128)
    assert mlp["fc2"]["q4"].shape == (2, 1, 64, 64)  # K 128 = one group of 128
    assert model.params["heads"]["q"].dtype == torch.int8 and model.default_kv_int8
    with pytest.raises(ValueError, match="bits"):
        model.quantize(bits=3)


def test_bridge_keeps_f32_leaves_of_a_bf16_model():
    m = JZonos.from_config(j_tiny(), seed=0, dtype=jnp.bfloat16).quantize(bits=4)
    p = params_from_jax(jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a),
                                     m.params), dtype=torch.bfloat16)
    layers = p["backbone"]["layers"]
    assert layers["attn"]["in_proj"]["q4"].dtype == torch.uint8
    assert layers["mlp"]["fc1"]["s4"].dtype == torch.float32
    assert p["heads"]["s"].dtype == torch.float32 and p["heads"]["q"].dtype == torch.int8
    assert p["prefix_conditioner"]["emotion"]["fourier_weight"].dtype == torch.float32
    assert p["prefix_conditioner"]["espeak"]["phoneme_embed"].dtype == torch.bfloat16
    assert layers["norm1"]["scale"].dtype == torch.bfloat16
    np.testing.assert_array_equal(p["prefix_conditioner"]["fmax"]["fourier_weight"].numpy(),
                                  np.asarray(m.params["prefix_conditioner"]["fmax"]["fourier_weight"]))
