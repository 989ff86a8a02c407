"""The port's generation runtime and DAC decoder against the JAX package's.

Tiny transformer (d 64, 2 layers) and the tiny DAC of bench.py, float32 on
the CPU. Greedy decoding must give IDENTICAL codes; sampled decoding cannot
be compared across frameworks (torch and jax random streams differ), so the
port's own per-row generator contract is checked instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zonos_tpu.codec import dac as JDAC
from zonos_tpu.config import tiny_transformer_config as j_tiny
from zonos_tpu.models.zonos import Zonos as JZonos
from zonos_tpu.ops.sampling import SamplingParams as JSP
from zonos_tpu.runtime import generate as JG
from zonos_tpu_torch.bridge import dac_params_from_jax, params_from_jax
from zonos_tpu_torch.codec import dac as TDAC
from zonos_tpu_torch.config import DACConfig, tiny_transformer_config
from zonos_tpu_torch.models.zonos import Zonos
from zonos_tpu_torch.ops.sampling import SamplingParams
from zonos_tpu_torch.runtime import generate as TG

CFG_J, CFG_T = j_tiny(), tiny_transformer_config()
EOS = CFG_J.eos_token_id
DAC_KW = dict(encoder_hidden_size=8, downsampling_ratios=(2, 4), decoder_hidden_size=32,
              upsampling_ratios=(4, 2), n_codebooks=9, codebook_size=1024, codebook_dim=4, hidden_size=24)


@pytest.fixture(scope="module")
def int8_model():
    m = JZonos.from_config(CFG_J, seed=0, dtype=jnp.float32).quantize()
    sub = {k: m.params[k] for k in ("embeddings", "heads", "backbone")}
    return m.params, params_from_jax(jax.tree.map(np.asarray, sub))


def _both(jparams, tparams, cond, b, kv, **kw):
    ref = JG.generate(jparams, CFG_J, cond, max_new_tokens=24, batch_size=b, sampling_params=JSP(temperature=0.0),
                      seed=0, dtype=jnp.float32, kv_int8=kv, return_lengths=True, **kw)
    got = TG.generate(tparams, CFG_T, cond, max_new_tokens=24, batch_size=b,
                      sampling_params=SamplingParams(temperature=0.0), seed=0, dtype=torch.float32,
                      kv_int8=kv, return_lengths=True, device="cpu", **kw)
    return ref, got


@pytest.mark.parametrize("b,kv_int8,prefix", [
    (1, False, 0), (1, True, 0), (2, False, 0), (2, True, 0), (1, True, 5),
])
def test_greedy_codes_identical(int8_model, b, kv_int8, prefix):
    rng = np.random.default_rng(b + prefix)
    cond = rng.normal(size=(2 * b, 10, 64)).astype(np.float32) * 0.5
    kw = {}
    if prefix:  # audio-prefix frames are kept and continued
        kw["audio_prefix_codes"] = rng.integers(0, 1024, size=(b, 9, prefix)).astype(np.int32)
    (ref, ref_len), (got, got_len) = _both(*int8_model, cond, b, kv_int8, **kw)
    assert got.shape == ref.shape == (b, 9, 24 + prefix)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got_len, ref_len)


@pytest.mark.parametrize("batched", [False, True])
def test_postprocess_and_eos_trim_match_jax(batched):
    from zonos_tpu.runtime.streaming import _eos_trim_lengths as j_trim
    from zonos_tpu_torch.runtime.streaming import _eos_trim_lengths as t_trim

    rng = np.random.default_rng(12)
    codes = rng.integers(0, 1026, size=(2, 9, 60)).astype(np.int32)
    codes[0, :6, 50] = EOS  # an EOS majority inside row 0's trailing window
    delayed = JG.apply_delay_pattern_np(codes, CFG_J.masked_token_id)
    offsets = np.array([60 + 9, 55 + 9])
    if batched:
        ref, ref_len = JG.postprocess_codes_batched(delayed, offsets, CFG_J)
        got, got_len = TG.postprocess_codes_batched(delayed, offsets, CFG_T)
        np.testing.assert_array_equal(got_len, ref_len)
        out = torch.from_numpy(TG.revert_delay_pattern_np(delayed))
        np.testing.assert_array_equal(
            t_trim(out, torch.from_numpy(offsets), CFG_T).numpy(),
            np.asarray(j_trim(jnp.asarray(out.numpy()), jnp.asarray(offsets), CFG_J)))
    else:
        ref = JG.postprocess_codes(delayed[:1], int(offsets[0]), CFG_J)
        got = TG.postprocess_codes(delayed[:1], int(offsets[0]), CFG_T)
    np.testing.assert_array_equal(got, ref)


def test_eos_staircase_identical():
    """The EOS rig of tests/test_batched_eos.py: zeroed params, norm_f.bias = e0
    and heads[0, EOS] = 7, so EOS wins codebook 0 and each row drains the
    EOS/MASK staircase; codes and per-row lengths must match."""
    m = JZonos.from_config(CFG_J, seed=0, dtype=jnp.float32)
    rig = jax.tree.map(jnp.zeros_like, m.params)
    rig["backbone"] = {**rig["backbone"], "norm_f": {
        **rig["backbone"]["norm_f"], "bias": rig["backbone"]["norm_f"]["bias"].at[0].set(1.0)}}
    rig["heads"] = rig["heads"].at[0, EOS].set(7.0)
    tparams = params_from_jax(jax.tree.map(np.asarray, {k: rig[k] for k in ("embeddings", "heads", "backbone")}))
    cond = np.random.default_rng(5).normal(size=(4, 10, 64)).astype(np.float32)
    (ref, ref_len), (got, got_len) = _both(rig, tparams, cond, 2, False)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got_len, ref_len)
    assert (got_len < 24).all()  # the staircase ended generation early


def test_batch_row_equals_solo_run(int8_model):
    _, tparams = int8_model
    cond = np.random.default_rng(6).normal(size=(2, 10, 64)).astype(np.float32) * 0.5
    other = np.random.default_rng(7).normal(size=(2, 10, 64)).astype(np.float32) * 0.5
    pair = np.concatenate([cond[:1], other[:1], cond[1:], other[1:]])  # cond rows ++ uncond rows
    kw = dict(max_new_tokens=16, sampling_params=SamplingParams(min_p=0.1), seed=11,
              dtype=torch.float32, kv_int8=True, device="cpu")
    solo = TG.generate(tparams, CFG_T, cond, batch_size=1, **kw)
    both = TG.generate(tparams, CFG_T, pair, batch_size=2, **kw)
    np.testing.assert_array_equal(both[0], solo[0])


# ---------------------------------------------------------------------------
# DAC decoder
# ---------------------------------------------------------------------------

def _np_dac_params(cfg, seed=0):
    """Decoder + quantizer params in the JAX layout (``init_dac_params``'s
    shapes), drawn with numpy: conv taps [K, Cin, Cout], the transposed convs'
    taps flipped along K as the JAX package stores them, non-zero biases and
    non-unit snake alphas."""
    rng = np.random.default_rng(seed)

    def arr(*shape, scale=0.02):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    def alpha(c):
        return rng.uniform(0.5, 1.5, size=(c,)).astype(np.float32)

    def conv(k, cin, cout):
        return {"w": arr(k, cin, cout, scale=0.3 / np.sqrt(k * cin)), "b": arr(cout)}

    def res(c):
        return {"snake1": alpha(c), "conv1": conv(7, c, c), "snake2": alpha(c), "conv2": conv(1, c, c)}

    dh = cfg.decoder_hidden_size
    blocks = [{"snake1": alpha(dh // 2**i), "conv_t": conv(2 * st, dh // 2**i, dh // 2 ** (i + 1)),
               "res": [res(dh // 2 ** (i + 1)) for _ in range(3)]} for i, st in enumerate(cfg.upsampling_ratios)]
    c_last = dh // 2 ** len(cfg.upsampling_ratios)
    decoder = {"conv1": conv(7, cfg.hidden_size, dh), "blocks": blocks, "snake_out": alpha(c_last),
               "conv2": conv(7, c_last, 1)}
    quantizer = {"codebooks": arr(cfg.n_codebooks, cfg.codebook_size, cfg.codebook_dim, scale=1.0),
                 "out_proj_w": arr(cfg.n_codebooks, cfg.codebook_dim, cfg.hidden_size, scale=0.5),
                 "out_proj_b": arr(cfg.n_codebooks, cfg.hidden_size)}
    return {"decoder": decoder, "quantizer": quantizer}


@pytest.fixture(scope="module")
def tiny_dac():
    jcfg = JDAC.DACConfig(**DAC_KW)
    np_params = _np_dac_params(jcfg)
    jparams = jax.tree.map(jnp.asarray, np_params)
    return jcfg, jparams, dac_params_from_jax(np_params)


@pytest.mark.parametrize("stride", [4, 2])
def test_conv_transpose_bridge_unflips_taps(tiny_dac, stride):
    _, jparams, tparams = tiny_dac
    blk = 0 if stride == 4 else 1
    jw, jb = jparams["decoder"]["blocks"][blk]["conv_t"]["w"], jparams["decoder"]["blocks"][blk]["conv_t"]["b"]
    x = np.random.default_rng(stride).normal(size=(2, 7, jw.shape[1])).astype(np.float32)
    ref = JDAC.conv_transpose1d(jnp.asarray(x), jw, jb, stride=stride, padding=(stride + 1) // 2)
    tw = tparams["decoder"]["blocks"][blk]["conv_t"]
    got = TDAC.conv_transpose1d(torch.from_numpy(x), tw["w"], tw["b"], stride=stride, padding=(stride + 1) // 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_conv1d_and_snake_channels_last(tiny_dac):
    _, jparams, tparams = tiny_dac
    jc, tc = jparams["decoder"]["conv1"], tparams["decoder"]["conv1"]
    x = np.random.default_rng(8).normal(size=(2, 9, jc["w"].shape[1])).astype(np.float32)
    ref = JDAC.conv1d(jnp.asarray(x), jc["w"], jc["b"], padding=3)
    got = TDAC.conv1d(torch.from_numpy(x), tc["w"], tc["b"], padding=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    alpha = np.linspace(0.5, 2.0, x.shape[-1]).astype(np.float32)
    np.testing.assert_allclose(TDAC.snake(torch.from_numpy(x), torch.from_numpy(alpha)).numpy(),
                               np.asarray(JDAC.snake(jnp.asarray(x), jnp.asarray(alpha))), rtol=1e-5, atol=1e-6)


def test_dac_decode_matches_jax(tiny_dac):
    jcfg, jparams, tparams = tiny_dac
    codes = np.random.default_rng(9).integers(0, 1024, size=(2, 9, 13)).astype(np.int32)
    ref_ae = JDAC.DACAutoencoder(params=jparams, cfg=jcfg, dtype=jnp.float32, frame_bucket=8)
    ae = TDAC.DACAutoencoder(params=tparams, cfg=DACConfig(**DAC_KW), dtype=torch.float32, frame_bucket=8, device="cpu")
    ref, got = ref_ae.decode(codes), ae.decode(codes)
    assert got.shape == ref.shape == (2, 1, 13 * 8)
    # float32 convolutions in two libraries: 1e-5 of the waveform's peak
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    ref16 = np.asarray(ref_ae.decode_device(jnp.asarray(codes), to_int16=True))
    got16 = ae.decode_device(codes, to_int16=True).numpy()
    assert got16.dtype == np.int16 and got16.shape == ref16.shape and np.abs(ref16).max() > 100
    assert np.abs(got16.astype(np.int32) - ref16.astype(np.int32)).max() <= 1  # truncation may land 1 LSB apart


def test_tiny_zonos_conditioning_to_pcm(tiny_dac):
    _, _, tparams = tiny_dac
    model = Zonos.from_config(CFG_T, seed=0, dtype=torch.float32, device="cpu").quantize()
    model._autoencoder = TDAC.DACAutoencoder(params=tparams, cfg=DACConfig(**DAC_KW), dtype=torch.float32,
                                             frame_bucket=8, device="cpu")
    assert model.default_kv_int8 and model.params["heads"]["q"].dtype == torch.int8
    cond = torch.randn(2, 10, 64, generator=torch.Generator().manual_seed(0)) * 0.5
    codes = model.generate(cond, max_new_tokens=12, seed=3, forbid_eos=True)
    assert codes.shape == (1, 9, 12) and codes.min() >= 0 and codes.max() < 1024
    pcm = model.autoencoder.decode_device(codes, to_int16=True)
    assert pcm.dtype == torch.int16 and pcm.shape == (1, 12 * 8)
