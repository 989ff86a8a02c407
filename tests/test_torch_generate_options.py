"""Request options of the port's loops that the JAX package has: one seed per
row, and the ``prefill_bucket``, ``audio_bucket`` and ``dac_context_frames``
keywords.

A seed sequence gives row i the stream that row 0 of a solo run at seed[i]
draws (JAX's ``seed_to_key``), through ``generate``, ``generate_audio``,
``generate_stream`` and the facade. The keywords change shapes only: at the
same values the port's greedy codes and PCM equal JAX's (tiny transformer and
tiny DAC, float32 on the CPU).
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
from zonos_tpu.runtime import streaming as JS
from zonos_tpu_torch.bridge import dac_params_from_jax, params_from_jax
from zonos_tpu_torch.codec.dac import DACAutoencoder
from zonos_tpu_torch.config import DACConfig, tiny_transformer_config
from zonos_tpu_torch.models.zonos import Zonos
from zonos_tpu_torch.runtime import generate as TG
from zonos_tpu_torch.runtime import streaming as TS

DAC_KW = dict(encoder_hidden_size=8, downsampling_ratios=(2, 4), decoder_hidden_size=32,
              upsampling_ratios=(4, 2), n_codebooks=9, codebook_size=1024, codebook_dim=4, hidden_size=24)
GREEDY, SAMPLED = {"temperature": 0.0}, {"min_p": 0.1}


@pytest.fixture(scope="module")
def models():
    jm = JZonos.from_config(j_tiny(), seed=0, dtype=jnp.float32).quantize()
    jcfg = JDAC.DACConfig(**DAC_KW)
    jdac = JDAC.init_dac_params(jax.random.key(1), jcfg)
    jm._autoencoder = JDAC.DACAutoencoder(params=jdac, cfg=jcfg, dtype=jnp.float32, frame_bucket=8)
    port = Zonos(tiny_transformer_config(), params_from_jax(jax.tree.map(np.asarray, jm.params)),
                 dtype=torch.float32, device="cpu")
    port.default_kv_int8 = True
    port._autoencoder = DACAutoencoder(params=dac_params_from_jax(jax.tree.map(np.asarray, jdac)),
                                       cfg=DACConfig(**DAC_KW), dtype=torch.float32, frame_bucket=8, device="cpu")
    return jm, port


def _pair(seed_a=1, seed_b=2):
    """Two requests' conditioning, solo ([2, Lc, D] each) and batched ([4, Lc, D])."""
    a = np.random.default_rng(seed_a).normal(size=(2, 10, 64)).astype(np.float32) * 0.5
    b = np.random.default_rng(seed_b).normal(size=(2, 10, 64)).astype(np.float32) * 0.5
    return a, b, np.concatenate([a[:1], b[:1], a[1:], b[1:]])  # cond rows ++ uncond rows


def test_row_generators_seed_contract():
    gens = TG.row_generators([7, 9], 2, "cpu")
    solo7, solo9 = TG.row_generators(7, 1, "cpu"), TG.row_generators(9, 1, "cpu")
    assert gens[0].initial_seed() == solo7[0].initial_seed() == TG.row_generators([7], 1, "cpu")[0].initial_seed()
    assert gens[1].initial_seed() == solo9[0].initial_seed()
    assert TG.row_generators(7, 2, "cpu")[1].initial_seed() != solo7[0].initial_seed()
    assert TG.row_generators(np.array([7, 9]), 2, "cpu")[1].initial_seed() == gens[1].initial_seed()
    with pytest.raises(ValueError, match="3 seeds for a batch of 2"):
        TG.row_generators([1, 2, 3], 2, "cpu")


def test_generate_batched_rows_equal_their_solo_runs(models):
    _, port = models
    a, b, both = _pair()
    kw = dict(max_new_tokens=20, sampling_params=SAMPLED)
    batched, lengths = port.generate(both, batch_size=2, seed=[7, 9], return_lengths=True, **kw)
    for i, (cond, seed) in enumerate(((a, 7), (b, 9))):
        solo = port.generate(cond, seed=seed, **kw)
        assert int(lengths[i]) == solo.shape[-1]
        np.testing.assert_array_equal(batched[i, :, :lengths[i]], solo[0])
    # an int seed draws other streams for row 1 than a solo run at that seed
    assert not np.array_equal(port.generate(both, batch_size=2, seed=9, **kw)[1], port.generate(b, seed=9, **kw)[0])


def test_generate_audio_and_stream_batched_rows_equal_their_solo_runs(models):
    _, port = models
    a, b, both = _pair(3, 4)
    kw = dict(max_new_tokens=40, sampling_params=SAMPLED)
    wav, lengths = port.generate_audio(both, batch_size=2, seed=[5, 6], **kw)
    hop = port.autoencoder.config.hop_length
    for i, (cond, seed) in enumerate(((a, 5), (b, 6))):
        solo, solo_len = port.generate_audio(cond, seed=seed, **kw)
        assert lengths[i] == solo_len[0]
        np.testing.assert_allclose(wav[i, :lengths[i] * hop], solo[0], rtol=0, atol=1e-5)
    streamed = [c for c, _ in TS.generate_stream(port.params, port.config, both, autoencoder=None, batch_size=2,
                                                 seed=[5, 6], kv_int8=True, dtype=torch.float32, device="cpu",
                                                 **kw)]
    codes = port.generate(both, batch_size=2, seed=[5, 6], **kw)
    np.testing.assert_array_equal(streamed[-1], codes)


@pytest.mark.parametrize("prefill_bucket,audio_bucket", [(64, 64), (16, 128)])
def test_bucket_keywords_match_jax(models, prefill_bucket, audio_bucket):
    jm, port = models
    cond = np.random.default_rng(8).normal(size=(2, 10, 64)).astype(np.float32) * 0.5
    kw = dict(max_new_tokens=30, seed=0, prefill_bucket=prefill_bucket, audio_bucket=audio_bucket)
    ref = JG.generate(jm.params, jm.config, cond, sampling_params=JSP(temperature=0.0), dtype=jnp.float32,
                      kv_int8=True, **kw)
    got = TG.generate(port.params, port.config, cond, sampling_params=GREEDY, dtype=torch.float32, kv_int8=True,
                      device="cpu", **kw)
    np.testing.assert_array_equal(got, ref)
    req = TG.prepare_request(port.config, cond, None, 30, 2.0, 1, None, 0, torch.float32, False, True, "cpu",
                             prefill_bucket, audio_bucket)
    assert req.statics.prefill_len % prefill_bucket == 0 and req.statics.delayed_len % audio_bucket == 0
    ref_wav, ref_len = JS.generate_audio(jm.params, jm.config, cond, jm.autoencoder, sampling_params=GREEDY,
                                         chunk_frames=16, dtype=jnp.float32, kv_int8=True, **kw)
    wav, lengths = TS.generate_audio(port.params, port.config, cond, port.autoencoder, sampling_params=GREEDY,
                                     chunk_frames=16, dtype=torch.float32, kv_int8=True, device="cpu", **kw)
    np.testing.assert_array_equal(lengths, ref_len)
    np.testing.assert_allclose(wav, ref_wav, rtol=0, atol=1e-4)


@pytest.mark.parametrize("context", [0, 4])  # the default, 16, in test_torch_streaming.py
def test_dac_context_frames_match_jax(models, context):
    jm, port = models
    cond = np.random.default_rng(9).normal(size=(2, 10, 64)).astype(np.float32) * 0.5
    kw = dict(max_new_tokens=30, sampling_params=GREEDY, seed=0, first_chunk_frames=12, chunk_frames=8,
              dac_context_frames=context, audio_bucket=64, kv_int8=True)
    ref = [c for c, _ in JS.generate_stream(jm.params, jm.config, cond, autoencoder=jm.autoencoder,
                                            dtype=jnp.float32, **kw)]
    got = [c for c, _ in TS.generate_stream(port.params, port.config, cond, autoencoder=port.autoencoder,
                                            dtype=torch.float32, device="cpu", **kw)]
    assert len(got) == len(ref) >= 2
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-4)
