"""The port's DAC encoder half against the JAX package's.

The tiny DAC of tests/test_audio_prep.py (hidden 24, codebook dim 4, hop 8)
on the CPU at float32, with weights drawn by numpy so that biases, Snake
alphas and codebooks are all non-trivial. Also pins the seeded decoder and
quantizer values that the port drew before the encoder existed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zonos_tpu.codec import dac as JDAC
from zonos_tpu_torch.bridge import dac_params_from_jax
from zonos_tpu_torch.codec import dac as TDAC
from zonos_tpu_torch.config import DACConfig

DAC_KW = dict(encoder_hidden_size=8, downsampling_ratios=(2, 4), decoder_hidden_size=32,
              upsampling_ratios=(4, 2), n_codebooks=9, codebook_size=1024, codebook_dim=4, hidden_size=24)


def _np_params(jcfg, seed=0):
    """JAX-layout params of ``init_dac_params``'s shapes with numpy values:
    conv taps scaled to keep unit gain, random biases and alphas."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, JDAC.init_dac_params(jax.random.key(0), jcfg))

    def draw(path, v):
        name = jax.tree_util.keystr(path)
        if "snake" in name:
            return rng.uniform(0.5, 1.5, size=v.shape).astype(np.float32)
        if name.endswith("['w']"):  # conv [K, Cin, Cout]
            return (rng.normal(size=v.shape) * 0.8 / np.sqrt(v.shape[0] * v.shape[1])).astype(np.float32)
        if name.endswith("['b']") or name.endswith("_b']"):
            return (rng.normal(size=v.shape) * 0.05).astype(np.float32)
        if "codebooks" in name:
            return rng.normal(size=v.shape).astype(np.float32)
        return (rng.normal(size=v.shape) / np.sqrt(v.shape[-2])).astype(np.float32)  # in/out projections

    return jax.tree_util.tree_map_with_path(draw, tree)


@pytest.fixture(scope="module")
def tiny():
    jcfg = JDAC.DACConfig(**DAC_KW)
    np_params = _np_params(jcfg)
    jae = JDAC.DACAutoencoder(params=jax.tree.map(jnp.asarray, np_params), cfg=jcfg, dtype=jnp.float32,
                              frame_bucket=8)
    tae = TDAC.DACAutoencoder(params=dac_params_from_jax(np_params), cfg=DACConfig(**DAC_KW),
                              dtype=torch.float32, frame_bucket=8, device="cpu")
    wav = (np.sin(np.linspace(0, 300, 8 * 40)) * 0.5
           + np.random.default_rng(1).normal(size=8 * 40) * 0.1).astype(np.float32)[None]
    return jae, tae, wav


def test_encoder_latents_match_jax(tiny):
    jae, tae, wav = tiny
    ref = np.asarray(JDAC.encoder_forward(jae.params["encoder"], jnp.asarray(wav), jae.config.downsampling_ratios))
    got = TDAC.encoder_forward(tae.params["encoder"], torch.from_numpy(wav), tae.config.downsampling_ratios).numpy()
    assert got.shape == ref.shape == (1, 40, 24)
    assert np.abs(ref).max() > 0.1  # the latents are not vanishingly small
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_quantizer_codes_identical(tiny):
    jae, tae, _ = tiny
    z = np.random.default_rng(2).normal(size=(2, 17, 24)).astype(np.float32)
    ref = np.asarray(JDAC.quantizer_encode(jae.params["quantizer"], jnp.asarray(z)))
    got = TDAC.quantizer_encode(tae.params["quantizer"], torch.from_numpy(z))
    assert got.dtype == torch.int32 and got.shape == (2, 9, 17)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert len(np.unique(ref)) > 50  # many codebook entries chosen, not one


@pytest.mark.parametrize("sr,n", [(44100, 333), (24000, 1000), (16000, 800)])
def test_preprocess_identical(tiny, sr, n):
    jae, tae, _ = tiny
    wav = np.random.default_rng(n).normal(size=(1, n)).astype(np.float32) * 0.3
    ref, got = jae.preprocess(wav, sr), tae.preprocess(wav, sr)
    assert got.shape == ref.shape and got.shape[-1] % 8 == 0
    np.testing.assert_array_equal(got, ref)


def test_encode_codes_identical(tiny):
    jae, tae, wav = tiny
    np.testing.assert_array_equal(tae.encode(wav), jae.encode(wav))
    np.testing.assert_array_equal(tae.encode(wav[:, None]), jae.encode(wav))  # [B, 1, T] accepted


def test_bridge_carries_encoder_and_in_proj(tiny):
    jae, tae, _ = tiny
    enc = tae.params["encoder"]
    assert enc["conv1"]["w"].shape == (8, 1, 7)
    assert enc["blocks"][1]["conv"]["w"].shape == (32, 16, 8)  # [Cout, Cin, 2 * stride]
    assert enc["conv2"]["w"].shape == (24, 32, 3)
    np.testing.assert_array_equal(tae.params["quantizer"]["in_proj_w"].numpy(),
                                  np.asarray(jae.params["quantizer"]["in_proj_w"]))


# float32 values of the seed-0 init drawn before the encoder was added:
# (leaf, sum in float64, first three values, last value)
PINNED = [
    (("decoder", "conv1", "w"), -0.1917049804405906,
     [-0.021780099719762802, -0.019056962803006172, 0.0033766317646950483], 0.0028117885813117027),
    (("decoder", "blocks", 1, "res", 2, "conv1", "w"), 0.6278806397021981,
     [-0.023752233013510704, 0.012581010349094868, -0.02739636041224003], -0.029056288301944733),
    (("decoder", "conv2", "w"), -0.13468594691948965,
     [-0.0260828398168087, 0.023375455290079117, -0.030241534113883972], -0.0018367742886766791),
    (("quantizer", "codebooks"), -1.994916748217065,
     [0.005923969205468893, -0.005784382112324238, -0.002816912718117237], 0.00690179318189621),
    (("quantizer", "out_proj_w"), 0.16630002261081245,
     [-0.024239854887127876, -0.00586767727509141, 0.01516736950725317], 0.036016032099723816),
]


def test_seeded_decoder_and_quantizer_unchanged_by_encoder():
    params = TDAC.init_dac_params(torch.Generator().manual_seed(0), DACConfig(**DAC_KW))
    assert {"encoder", "decoder", "quantizer"} <= set(params)
    assert params["quantizer"]["in_proj_w"].shape == (9, 24, 4)
    for path, total, first, last in PINNED:
        leaf = params
        for key in path:
            leaf = leaf[key]
        flat = leaf.reshape(-1)
        assert float(flat.double().sum()) == total, path
        assert [float(x) for x in flat[:3]] == first and float(flat[-1]) == last, path
