"""The port's segmented request loops against its own whole-request path and
against the JAX package's, on the tiny config and the tiny DAC at float32.

``chunk_frames`` is always given, so the JAX side never probes its link.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zonos_tpu.codec import dac as JDAC
from zonos_tpu.config import tiny_transformer_config as j_tiny
from zonos_tpu.models.zonos import Zonos as JZonos
from zonos_tpu.runtime import streaming as JS
from zonos_tpu_torch.bridge import dac_params_from_jax, params_from_jax
from zonos_tpu_torch.codec.dac import DACAutoencoder
from zonos_tpu_torch.config import DACConfig, tiny_transformer_config
from zonos_tpu_torch.models.zonos import Zonos
from zonos_tpu_torch.runtime import streaming as TS

DAC_KW = dict(encoder_hidden_size=8, downsampling_ratios=(2, 4), decoder_hidden_size=32,
              upsampling_ratios=(4, 2), n_codebooks=9, codebook_size=1024, codebook_dim=4, hidden_size=24)
GREEDY = {"temperature": 0.0}
SAMPLED = {"min_p": 0.1}


@pytest.fixture(scope="module")
def models():
    jm = JZonos.from_config(j_tiny(), seed=0, dtype=jnp.float32)
    jcfg = JDAC.DACConfig(**DAC_KW)
    jdac_params = JDAC.init_dac_params(jax.random.key(0), jcfg)
    jm._autoencoder = JDAC.DACAutoencoder(params=jdac_params, cfg=jcfg, dtype=jnp.float32, frame_bucket=8)
    port = Zonos(tiny_transformer_config(), params_from_jax(jax.tree.map(np.asarray, jm.params)),
                 dtype=torch.float32, device="cpu")
    port._autoencoder = DACAutoencoder(params=dac_params_from_jax(jax.tree.map(np.asarray, jdac_params)),
                                       cfg=DACConfig(**DAC_KW), dtype=torch.float32, frame_bucket=8, device="cpu")
    return jm, port


def _cond(b, seed=1):
    return np.random.default_rng(seed).normal(size=(2 * b, 10, 64)).astype(np.float32) * 0.5


@pytest.mark.parametrize("sampling,pcm_int16", [(GREEDY, False), (SAMPLED, False), (SAMPLED, True)],
                         ids=["greedy", "sampled", "sampled-int16"])
def test_generate_audio_matches_generate_and_decode(models, sampling, pcm_int16):
    _, port = models
    cond = _cond(1)
    codes, lengths = port.generate(cond, max_new_tokens=120, sampling_params=sampling, seed=11,
                                   return_lengths=True)
    ref = port.autoencoder.decode_device(codes, to_int16=pcm_int16).numpy()
    wav, plengths = TS.generate_audio(port.params, port.config, cond, port.autoencoder, max_new_tokens=120,
                                      sampling_params=sampling, seed=11, chunk_frames=32, dtype=torch.float32,
                                      pcm_int16=pcm_int16, device="cpu")
    np.testing.assert_array_equal(plengths, lengths)
    assert wav.shape == ref.shape and wav.dtype == ref.dtype
    if pcm_int16:  # the same float samples up to 1e-5, then truncated: at most 1 LSB apart
        assert np.abs(wav.astype(np.int32) - ref.astype(np.int32)).max() <= 1
    else:  # convolution sums run in another order for another piece shape
        np.testing.assert_allclose(wav, ref, rtol=0, atol=1e-5)


def test_facade_generate_audio_matches_jax(models):
    jm, port = models
    cond = _cond(1, seed=3)
    ref, ref_len = JS.generate_audio(jm.params, jm.config, cond, jm.autoencoder, max_new_tokens=120,
                                     sampling_params=GREEDY, seed=0, chunk_frames=32, dtype=jnp.float32)
    wav, lengths = port.generate_audio(cond, max_new_tokens=120, sampling_params=GREEDY, seed=0)
    np.testing.assert_array_equal(lengths, ref_len)
    assert wav.shape == ref.shape
    np.testing.assert_allclose(wav, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("b", [1, 2])
def test_generate_stream_matches_jax(models, b):
    """Chunk by chunk the port's stream equals JAX's at greedy (each chunk is
    decoded with left context only, in both), with the same lengths and final
    flags; the chunks add up to the whole request's length."""
    jm, port = models
    cond = _cond(b, seed=5)
    kw = dict(max_new_tokens=40, batch_size=b, sampling_params=GREEDY, seed=0, first_chunk_frames=6,
              chunk_frames=8)
    ref = list(JS.generate_stream(jm.params, jm.config, cond, autoencoder=jm.autoencoder, dtype=jnp.float32, **kw))
    got = list(TS.generate_stream(port.params, port.config, cond, autoencoder=port.autoencoder,
                                  dtype=torch.float32, device="cpu", **kw))
    assert len(got) == len(ref) >= 2
    for (g, sr), (r, rsr) in zip(got, ref):
        assert sr == rsr == 44100
        if b == 1:
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-5)
        else:
            np.testing.assert_allclose(g[0], r[0], rtol=0, atol=1e-5)
            np.testing.assert_array_equal(g[1], r[1])
            np.testing.assert_array_equal(g[2], r[2])
    codes, lengths = port.generate(cond, max_new_tokens=40, batch_size=b, sampling_params=GREEDY, seed=0,
                                   kv_int8=False, return_lengths=True)
    total = np.concatenate([c if b == 1 else c[0] for c, _ in got], axis=-1)
    assert total.shape[-1] == int(lengths.max()) * port.autoencoder.config.hop_length
    if b > 1:
        np.testing.assert_array_equal(got[-1][0][1], lengths)
        assert got[-1][0][2].all()


def test_stream_codes_and_callback_match_generate(models):
    _, port = models
    cond = _cond(1, seed=7)
    ref = port.generate(cond, max_new_tokens=30, sampling_params=SAMPLED, seed=4)
    calls = []
    got = port.generate(cond, max_new_tokens=30, sampling_params=SAMPLED, seed=4, callback_interval=8,
                        callback=lambda _, steps, max_steps: calls.append((steps, max_steps)))
    np.testing.assert_array_equal(got, ref)
    assert [s for s, _ in calls] == [8, 16, 24, 32] and {m for _, m in calls} == {37}
    stopped = port.generate(cond, max_new_tokens=30, sampling_params=SAMPLED, seed=4, callback_interval=8,
                            callback=lambda *_: False)
    assert stopped.shape[-1] < ref.shape[-1]
    np.testing.assert_array_equal(stopped, ref[..., :stopped.shape[-1]])


def test_facade_stream_yields_incremental_audio(models):
    _, port = models
    hop = port.autoencoder.config.hop_length
    chunks = [wav for wav, _ in port.stream(_cond(1), max_new_tokens=20, seed=3, first_chunk_frames=4,
                                              chunk_frames=8, sampling_params=SAMPLED)]
    assert len(chunks) >= 2 and chunks[0].shape[0] <= (4 + 8) * hop
    assert np.isfinite(np.concatenate(chunks)).all()
