"""The port's request pipeline against the JAX package's, on the CPU.

Tiny models at float32: the speaker tower (in_planes 4), the DAC of
tests/test_audio_prep.py and the tiny transformer quantized to int8. Wav
files are written from numpy seeds; the caches live under the test's own
directory.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_dac_encoder import DAC_KW, _np_params
from zonos_tpu.audio.io import write_wav as j_write_wav
from zonos_tpu.codec import dac as JDAC
from zonos_tpu.config import tiny_transformer_config as j_tiny
from zonos_tpu.models.zonos import Zonos as JZonos
from zonos_tpu.serving import audio_prep as JAP
from zonos_tpu.serving import pipeline as JP
from zonos_tpu.speaker.embedding import SpeakerEmbeddingLDA as JSpeaker
from zonos_tpu.speaker.resnet import init_speaker_params
from zonos_tpu_torch.audio.io import read_wav
from zonos_tpu_torch.bridge import dac_params_from_jax, params_from_jax, speaker_params_from_jax
from zonos_tpu_torch.codec.dac import DACAutoencoder
from zonos_tpu_torch.config import DACConfig, tiny_transformer_config
from zonos_tpu_torch.models.zonos import Zonos
from zonos_tpu_torch.serving import audio_prep as TAP
from zonos_tpu_torch.serving import pipeline as TP
from zonos_tpu_torch.speaker.embedding import SpeakerEmbeddingLDA

TEXT = "Hello there, traveler."
GREEDY = {"temperature": 0.0}


@pytest.fixture(scope="module")
def models():
    """(JAX, port) pairs of the speaker model and of the int8 tiny Zonos with its tiny DAC."""
    jspk = JSpeaker(params=init_speaker_params(jax.random.key(0), in_planes=4, layer_plan=(1, 1, 1, 1)),
                    frame_bucket=64)
    tspk = SpeakerEmbeddingLDA(params=speaker_params_from_jax(jax.tree.map(np.asarray, jspk.params)),
                               lda={"w": torch.from_numpy(np.array(jspk.lda["w"]).T.copy()),
                                    "b": torch.from_numpy(np.array(jspk.lda["b"]))},
                               frame_bucket=64, device="cpu")
    jcfg = JDAC.DACConfig(**DAC_KW)
    dac_np = _np_params(jcfg, seed=3)
    jm = JZonos.from_config(j_tiny(), seed=0, dtype=jnp.float32).quantize()
    jm._autoencoder = JDAC.DACAutoencoder(params=jax.tree.map(jnp.asarray, dac_np), cfg=jcfg, dtype=jnp.float32,
                                          frame_bucket=8)
    tm = Zonos(tiny_transformer_config(), params_from_jax(jax.tree.map(np.asarray, jm.params)),
               dtype=torch.float32, device="cpu")
    tm._autoencoder = DACAutoencoder(params=dac_params_from_jax(dac_np), cfg=DACConfig(**DAC_KW),
                                     dtype=torch.float32, frame_bucket=8, device="cpu")
    return jspk, tspk, jm, tm


def _write(path, seconds, sr, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    wav = 0.3 * np.sin(2 * np.pi * (150 + 40 * seed) * t) + 0.05 * rng.normal(size=t.shape)
    j_write_wav(str(path), wav.astype(np.float32), sr)
    return str(path)


class _Counting:
    def __init__(self, model):
        self.model, self.calls = model, 0

    def __call__(self, wav, sr):
        self.calls += 1
        return self.model(wav, sr)


def test_process_speaker_audio_cached_like_jax(tmp_path, monkeypatch, models):
    jspk, tspk, _, _ = models
    monkeypatch.chdir(tmp_path)
    path = _write(tmp_path / "serving_spk_a.wav", 0.6, 24000, seed=1)
    ref = JAP.process_speaker_audio(path, "torch-serving", use_cache=False, speaker_model=jspk)
    counting = _Counting(tspk)
    emb = TAP.process_speaker_audio(path, "torch-serving", speaker_model=counting)
    assert emb.shape == (1, 1, 128) and emb.dtype == np.float32
    np.testing.assert_allclose(emb, ref, rtol=1e-4, atol=1e-4)
    again = TAP.process_speaker_audio(path, "torch-serving", speaker_model=counting)
    assert counting.calls == 1  # the second call is a cache hit
    np.testing.assert_array_equal(again, emb)
    # the JAX package's on-disk layout, which JAX's own cache reads back
    disk = tmp_path / "cache" / "embeds" / "torch-serving" / "serving_spk_a.npz"
    np.testing.assert_array_equal(np.load(disk)["data"], emb)


def test_process_prefix_audio_cached_like_jax(tmp_path, monkeypatch, models):
    _, _, jm, tm = models
    monkeypatch.chdir(tmp_path)
    path = _write(tmp_path / "serving_prefix_a.wav", 0.05, 44100, seed=2)
    ref = JAP.process_prefix_audio(path, jm.autoencoder, use_cache=False)
    codes = TAP.process_prefix_audio(path, tm.autoencoder)
    assert codes.shape == (1, 9, -(-2205 // 8))
    np.testing.assert_array_equal(codes, ref)
    calls = []
    real_encode = tm.autoencoder.encode
    monkeypatch.setattr(tm.autoencoder, "encode", lambda wav: calls.append(1) or real_encode(wav))
    np.testing.assert_array_equal(TAP.process_prefix_audio(path, tm.autoencoder), codes)
    assert not calls  # served from the cache
    assert (tmp_path / "cache" / "prefixes" / "serving_prefix_a.npz").exists()


def test_voice_clone_slice_matches_jax(tmp_path, models):
    """Speaker wav → embedding, prefix wav → codes, build_cond_dict,
    prepare_conditioning and a greedy generate continuing those codes: the
    codes are identical to JAX's, and the tiny DAC's PCM within 1e-4."""
    jspk, tspk, jm, tm = models
    spk = _write(tmp_path / "slice_spk.wav", 0.8, 24000, seed=3)
    pre = _write(tmp_path / "slice_prefix.wav", 0.01, 44100, seed=4)

    j_emb = JAP.process_speaker_audio(spk, "slice", use_cache=False, speaker_model=jspk)
    j_pre = JAP.process_prefix_audio(pre, jm.autoencoder, use_cache=False)
    j_cond = jm.prepare_conditioning(JP.build_cond_dict(jm, TEXT, speaker=j_emb))
    j_codes, j_len = jm.generate(j_cond, audio_prefix_codes=j_pre, max_new_tokens=24, sampling_params=GREEDY,
                                 seed=0, kv_int8=True, return_lengths=True)

    t_emb = TAP.process_speaker_audio(spk, "slice", use_cache=False, speaker_model=tspk)
    t_pre = TAP.process_prefix_audio(pre, tm.autoencoder, use_cache=False)
    np.testing.assert_allclose(t_emb, j_emb, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(t_pre, j_pre)
    t_cond = tm.prepare_conditioning(TP.build_cond_dict(tm, TEXT, speaker=t_emb))
    np.testing.assert_allclose(t_cond.numpy(), np.asarray(j_cond), rtol=1e-4, atol=1e-4)
    t_codes, t_len = tm.generate(t_cond, audio_prefix_codes=t_pre, max_new_tokens=24, sampling_params=GREEDY,
                                 seed=0, kv_int8=True, return_lengths=True)

    lp = j_pre.shape[-1]
    assert t_codes.shape == j_codes.shape and t_codes.shape[-1] > lp
    np.testing.assert_array_equal(t_codes, j_codes)
    np.testing.assert_array_equal(t_len, j_len)
    np.testing.assert_array_equal(t_codes[..., :lp], t_pre)  # the prefix is continued, not replaced
    ref_pcm, pcm = jm.autoencoder.decode(j_codes), tm.autoencoder.decode(t_codes)
    assert pcm.shape == ref_pcm.shape
    np.testing.assert_allclose(pcm, ref_pcm, rtol=0, atol=1e-4)


def test_tts_writes_the_request_wav(tmp_path, monkeypatch, models):
    """tts with a speaker wav (warmed into the cache as the server does at
    start-up) and a prefix wav: the file holds the generated frames."""
    _, tspk, _, tm = models
    monkeypatch.chdir(tmp_path)
    spk_dir = tmp_path / "speakers"
    spk_dir.mkdir()
    spk = _write(spk_dir / "tts_npc.wav", 0.5, 22050, seed=5)
    pre = _write(tmp_path / "tts_prefix.wav", 0.01, 44100, seed=6)
    assert TAP.init_latent_cache(str(spk_dir), "tts-model", speaker_model=tspk) == 1

    stats = {}
    out = str(tmp_path / "out" / "tts.wav")
    path, wav, sr, rtf = TP.tts(tm, "Hi there.", speaker_audio=spk, prefix_audio=pre, model_name="tts-model",
                                randomize_seed=False, seed=3, output_path=out, stats=stats)
    assert path == out and os.path.exists(out) and sr == 44100 and rtf > 0
    assert {"speaker_s", "prefix_s", "prefill_s", "decode_steps"} <= set(stats)

    params = TP.prepare_generation_params("Hi there.", seed=3, randomize_seed=False)
    cond = tm.prepare_conditioning(TP.build_cond_dict(tm, "Hi there.",
                                                      speaker=TAP.process_speaker_audio(spk, "tts-model")))
    codes = tm.generate(cond, audio_prefix_codes=TAP.process_prefix_audio(pre, tm.autoencoder),
                        max_new_tokens=params.max_new_tokens, sampling_params=params.sampling, seed=3)
    back, back_sr = read_wav(out)
    assert back_sr == 44100
    assert wav.shape == (codes.shape[-1] * 8,) == back.shape[1:]
    assert wav.dtype == np.int16  # ZONOS_PCM_INT16 defaults on


def test_prepare_generation_params_and_chunk_plan_match_jax():
    for text in ("x" * 10, "ab", "x" * 10_000):
        assert vars(TP.prepare_generation_params(text, randomize_seed=False, seed=7)) == \
            vars(JP.prepare_generation_params(text, randomize_seed=False, seed=7))
    long_text = " ".join(f"Sentence number {i} goes here." for i in range(40))
    jp = JP.prepare_generation_params(long_text, randomize_seed=False, seed=11)
    tp = TP.prepare_generation_params(long_text, randomize_seed=False, seed=11)
    j_plan = JP.plan_chunks(long_text, jp, 2.0, 0.1)
    t_plan = TP.plan_chunks(long_text, tp, 2.0, 0.1)
    assert len(t_plan) == len(j_plan) > 1
    assert [(c, vars(p)) for c, p in t_plan] == [(c, vars(p)) for c, p in j_plan]
