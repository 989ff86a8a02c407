"""The port's speaker tower against the JAX package's.

Tiny towers (in_planes 4, 80 mel bands) on the CPU at float32: the log-fbank
features, the embedding and its LDA projection from the same weights, and a
reference-named state dict read by both packages' converters. The inputs are
made with numpy from a seed.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zonos_tpu.speaker import embedding as JE
from zonos_tpu.speaker import resnet as JR
from zonos_tpu.speaker.fbank import log_fbank as j_log_fbank
from zonos_tpu_torch.bridge import speaker_params_from_jax
from zonos_tpu_torch.speaker import embedding as TE
from zonos_tpu_torch.speaker import resnet as TR
from zonos_tpu_torch.speaker.fbank import log_fbank

TOL = dict(rtol=1e-4, atol=1e-4)


def _j_lda(seed=1):
    rng = np.random.default_rng(seed)
    return {"w": (rng.normal(size=(256, 128)) * 0.05).astype(np.float32),
            "b": (rng.normal(size=(128,)) * 0.01).astype(np.float32)}


def _t_lda(j_lda):
    return {"w": torch.from_numpy(j_lda["w"].T.copy()), "b": torch.from_numpy(j_lda["b"])}


def _wav(seconds, sr, seed, channels=None):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    wav = 0.3 * np.sin(2 * np.pi * 180 * t) + 0.05 * rng.normal(size=t.shape)
    if channels:
        wav = np.stack([wav, 0.5 * wav + 0.02 * rng.normal(size=t.shape)][:channels])
    return wav.astype(np.float32)


def test_log_fbank_matches_jax():
    wav = (np.random.default_rng(0).normal(size=(2, 16000)) * 0.3).astype(np.float32)
    ref = np.asarray(j_log_fbank(jnp.asarray(wav)))
    got = log_fbank(torch.from_numpy(wav)).numpy()
    assert got.shape == ref.shape == (2, 80, 101)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("plan", [(1, 1, 1, 1), (2, 2, 1, 1)], ids=["plan1111", "plan2211"])
def test_tiny_tower_embedding_and_lda_match_jax(plan):
    """Weights through ``speaker_params_from_jax``; (2, 2, 1, 1) runs the
    stacked ``rest`` blocks of the first two stages."""
    jparams = JR.init_speaker_params(jax.random.key(3), in_planes=4, layer_plan=plan)
    rng = np.random.default_rng(4)  # non-identity folded BatchNorm
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, v: v * (1 + 0.2 * rng.normal(size=v.shape)).astype(np.float32)
        if "scale" in jax.tree_util.keystr(path) else v + 0.1 * rng.normal(size=v.shape).astype(np.float32)
        if "bias" in jax.tree_util.keystr(path) else v, jparams)
    tparams = speaker_params_from_jax(jax.tree.map(np.asarray, jparams))
    if plan[0] > 1:
        assert tparams["resnet"]["stages"][0]["rest"]["conv1"].shape == (plan[0] - 1, 4, 4, 3, 3)
    jlda = _j_lda()
    ref_model = JE.SpeakerEmbeddingLDA(params=jparams, lda=jax.tree.map(jnp.asarray, jlda), frame_bucket=64)
    model = TE.SpeakerEmbeddingLDA(params=tparams, lda=_t_lda(jlda), frame_bucket=64, device="cpu")
    wav = _wav(0.7, 16000, seed=5)
    (ref_emb, ref_lda), (emb, lda) = ref_model(wav, 16000), model(wav, 16000)
    assert emb.shape == (1, 256) and lda.shape == (1, 128)
    np.testing.assert_allclose(emb, ref_emb, **TOL)
    np.testing.assert_allclose(lda, ref_lda, **TOL)


def test_embedding_resamples_and_mixes_24khz_stereo():
    jparams = JR.init_speaker_params(jax.random.key(0), in_planes=4, layer_plan=(1, 1, 1, 1))
    jlda = _j_lda(2)
    ref_model = JE.SpeakerEmbeddingLDA(params=jparams, lda=jax.tree.map(jnp.asarray, jlda), frame_bucket=64)
    model = TE.SpeakerEmbeddingLDA(params=speaker_params_from_jax(jax.tree.map(np.asarray, jparams)),
                                   lda=_t_lda(jlda), frame_bucket=64, device="cpu")
    wav = _wav(1.0, 24000, seed=6, channels=2)
    (ref_emb, ref_lda), (emb, lda) = ref_model(wav, 24000), model(wav, 24000)
    np.testing.assert_allclose(emb, ref_emb, **TOL)
    np.testing.assert_allclose(lda, ref_lda, **TOL)
    # the bucket: 1 s at 16 kHz is 101 frames → 128, i.e. 127 hops of samples
    assert model._bucket_pad(np.zeros((1, 16000), np.float32)).shape == (1, 127 * 160)


def _reference_state_dict(rng, in_planes=4, plan=(2, 1, 1, 1), acoustic_dim=80, embd=256):
    """Random weights under the reference checkpoint's names (numpy)."""
    sd = {}

    def conv(name, co, ci, k):
        sd[name] = (rng.normal(size=(co, ci, k, k)) / np.sqrt(k * k * ci)).astype(np.float32)

    def bn(name, c):
        sd[f"{name}.weight"] = (1 + 0.2 * rng.normal(size=c)).astype(np.float32)
        sd[f"{name}.bias"] = (0.1 * rng.normal(size=c)).astype(np.float32)
        sd[f"{name}.running_mean"] = (0.2 * rng.normal(size=c)).astype(np.float32)
        sd[f"{name}.running_var"] = rng.uniform(0.5, 1.5, size=c).astype(np.float32)
        sd[f"{name}.num_batches_tracked"] = np.array(10, np.int64)

    conv("front.conv1.weight", in_planes, 1, 3)
    bn("front.bn1", in_planes)
    ci = in_planes
    for li, n in enumerate(plan):
        co = in_planes * 2**li
        for bi in range(n):
            p = f"front.layer{li + 1}.{bi}"
            conv(f"{p}.conv1.weight", co, ci if bi == 0 else co, 3)
            bn(f"{p}.bn1", co)
            conv(f"{p}.conv2.weight", co, co, 3)
            bn(f"{p}.bn2", co)
            if bi == 0 and li > 0:
                conv(f"{p}.downsample.0.weight", co, ci, 1)
                bn(f"{p}.downsample.1", co)
        ci = co
    feat = in_planes * 8 * (acoustic_dim // 8)
    sd["pooling.attention.0.weight"] = (rng.normal(size=(128, feat, 1)) * 0.05).astype(np.float32)
    sd["pooling.attention.0.bias"] = (rng.normal(size=128) * 0.05).astype(np.float32)
    bn("pooling.attention.2", 128)
    sd["pooling.attention.3.weight"] = (rng.normal(size=(feat, 128, 1)) * 0.05).astype(np.float32)
    sd["pooling.attention.3.bias"] = (rng.normal(size=feat) * 0.05).astype(np.float32)
    sd["bottleneck.weight"] = (rng.normal(size=(embd, 2 * feat)) * 0.02).astype(np.float32)
    sd["bottleneck.bias"] = (rng.normal(size=embd) * 0.02).astype(np.float32)
    return sd


def test_reference_state_dict_gives_the_jax_embedding():
    plan = (2, 1, 1, 1)
    sd = _reference_state_dict(np.random.default_rng(7), plan=plan)
    jparams = JR.speaker_state_dict_to_params(sd, in_planes=4, layer_plan=plan)
    tparams = TR.speaker_state_dict_to_params({k: torch.from_numpy(v) for k, v in sd.items()}, layer_plan=plan)
    fb = np.random.default_rng(8).normal(size=(2, 80, 48)).astype(np.float32)
    ref = np.asarray(JR.speaker_encoder_forward(jparams, jnp.asarray(fb)))
    got = TR.speaker_encoder_forward(tparams, torch.from_numpy(fb)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_checkpoint_files_and_default_model(tmp_path, monkeypatch, caplog):
    """Local checkpoint files (``torch.load(weights_only=True)``) give the JAX
    embedding of the same state dict; ``default_speaker_model`` finds them in
    a local hub cache, and without them falls back to a random tower with a
    warning."""
    plan = (2, 1, 1, 1)
    sd = _reference_state_dict(np.random.default_rng(9), plan=plan)
    jlda = _j_lda(3)
    snap = tmp_path / "hub" / "models--Zyphra--Zonos-v0.1-speaker-embedding" / "snapshots" / "abc"
    snap.mkdir(parents=True)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, snap / TE.CKPT_NAME)
    torch.save({"weight": torch.from_numpy(jlda["w"].T.copy()), "bias": torch.from_numpy(jlda["b"])},
               snap / TE.LDA_NAME)
    ref_model = JE.SpeakerEmbeddingLDA(params=JR.speaker_state_dict_to_params(sd, in_planes=4, layer_plan=plan),
                                       lda=jax.tree.map(jnp.asarray, jlda), frame_bucket=64)
    wav = _wav(0.5, 16000, seed=10)
    ref_emb, ref_lda = ref_model(wav, 16000)

    model = TE.SpeakerEmbeddingLDA(ckpt_path=str(snap / TE.CKPT_NAME), lda_ckpt_path=str(snap / TE.LDA_NAME),
                                   frame_bucket=64, device="cpu")
    np.testing.assert_allclose(model(wav, 16000)[1], ref_lda, **TOL)

    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    TE._default_speaker_model.cache_clear()
    try:
        found = TE.default_speaker_model(device="cpu")
        assert found is TE.default_speaker_model(device="cpu")  # one shared instance
        assert found.params["resnet"]["stages"][0]["rest"]["conv1"].shape[0] == 1
        found.frame_bucket = 64
        np.testing.assert_allclose(found(wav, 16000)[0], ref_emb, **TOL)
        np.testing.assert_allclose(TE.make_speaker_embedding(wav, 16000, device="cpu"), ref_lda[None], **TOL)

        monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "empty"))
        TE._default_speaker_model.cache_clear()
        with caplog.at_level(logging.WARNING, logger="zonos_tpu_torch"):
            fallback = TE.default_speaker_model(device="cpu")
        assert "random tower" in caplog.text
        assert fallback.params["resnet"]["stages"][2]["rest"]["conv1"].shape == (63, 256, 256, 3, 3)
    finally:
        TE._default_speaker_model.cache_clear()
