"""The port's training data pipeline (``zonos_tpu_torch/training/data.py``)
against the JAX package's (``zonos_tpu/training/data.py``).

Tiny transformer (bridged params), float32 on the CPU: ``build_batch``'s
conditioning at 1e-4 and its delayed codes and loss mask equal, for texts of
two languages and a per-sample speaker; ``synthetic_dataset`` equal;
``encode_wav_example`` through the tiny DAC equal to JAX's codes;
``PrefetchLoader`` yields every batch and raises its producer's error; and a
short training loop on ``build_batch``'s batches lowers the loss, for the
transformer and the hybrid (mirroring ``tests/test_training_data.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zonos_tpu.codec import dac as JDAC
from zonos_tpu.config import tiny_hybrid_config as j_tiny_hybrid
from zonos_tpu.config import tiny_transformer_config as j_tiny
from zonos_tpu.models.zonos import Zonos as JZonos
from zonos_tpu.training import data as JD
from zonos_tpu_torch.bridge import dac_params_from_jax, params_from_jax
from zonos_tpu_torch.codec import dac as TDAC
from zonos_tpu_torch.config import DACConfig, tiny_hybrid_config, tiny_transformer_config
from zonos_tpu_torch.models.zonos import Zonos
from zonos_tpu_torch.training import data as TD
from zonos_tpu_torch.training import train as TT


def _pair(jcfg, tcfg):
    jm = JZonos.from_config(jcfg, seed=0, dtype=jnp.float32)
    tm = Zonos(tcfg, params_from_jax(jax.tree.map(np.asarray, jm.params)), dtype=torch.float32, device="cpu")
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return _pair(j_tiny(), tiny_transformer_config())


def test_synthetic_dataset_equals_jax():
    for kw in ({"n": 5}, {"n": 3, "n_q": 4, "min_frames": 2, "max_frames": 6, "seed": 9}):
        got, want = TD.synthetic_dataset(**kw), JD.synthetic_dataset(**kw)
        assert [e.text for e in got] == [e.text for e in want]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.codes, w.codes)
            assert (g.language, g.speaker) == (w.language, w.speaker)


def test_build_batch_matches_jax(models):
    jm, tm = models
    rng = np.random.default_rng(0)
    ds = TD.synthetic_dataset(3, seed=2)
    ds[1].language = "de"
    ds[2].speaker = rng.normal(size=(1, 1, 128)).astype(np.float32)
    jds = [JD.TTSExample(text=e.text, codes=e.codes, language=e.language, speaker=e.speaker) for e in ds]
    cond, delayed, mask = TD.build_batch(tm, ds, frames=20)
    jcond, jdelayed, jmask = JD.build_batch(jm, jds, frames=20)
    assert all(isinstance(a, np.ndarray) for a in (cond, delayed, mask))
    assert cond.dtype == np.float32 and cond.shape == np.asarray(jcond).shape and cond.shape[0] == 3
    np.testing.assert_allclose(cond, np.asarray(jcond), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(delayed, jdelayed)
    np.testing.assert_array_equal(mask, jmask)
    assert delayed.shape == (3, 9, 20 + 9) and mask.shape == (3, 20 + 9 - 1)
    assert mask.sum(axis=1).min() < mask.shape[1]  # shorter samples have masked tails


def test_encode_wav_example_matches_jax():
    from tests.test_torch_dac_encoder import DAC_KW, _np_params

    jcfg = JDAC.DACConfig(**DAC_KW)
    np_params = _np_params(jcfg)
    jae = JDAC.DACAutoencoder(params=jax.tree.map(jnp.asarray, np_params), cfg=jcfg, dtype=jnp.float32,
                              frame_bucket=8)
    tae = TDAC.DACAutoencoder(params=dac_params_from_jax(np_params), cfg=DACConfig(**DAC_KW),
                              dtype=torch.float32, frame_bucket=8, device="cpu")
    wav = (np.sin(np.linspace(0, 300, 8 * 40)) * 0.5).astype(np.float32)
    got = TD.encode_wav_example(tae, "hello", wav, 44100, language="fr-fr")
    want = JD.encode_wav_example(jae, "hello", wav, 44100, language="fr-fr")
    assert (got.text, got.language) == ("hello", "fr-fr")
    assert got.codes.dtype == np.int32 and got.codes.shape == (9, 40)
    np.testing.assert_array_equal(got.codes, np.asarray(want.codes))


def test_prefetch_loader(models):
    _jm, tm = models
    ds = TD.synthetic_dataset(2)
    loader = TD.PrefetchLoader(lambda: TD.build_batch(tm, ds, frames=12), num_batches=3)
    assert len(loader) == 3
    batches = list(loader)
    assert len(batches) == 3
    for _cond, delayed, _mask in batches:
        assert delayed.shape[-1] == 12 + 9

    def broken():
        raise RuntimeError("featurization failed")

    with pytest.raises(RuntimeError, match="featurization failed"):
        list(TD.PrefetchLoader(broken, num_batches=2))


@pytest.mark.parametrize("kind", ["transformer", "hybrid"])
def test_training_loop_on_built_batches_lowers_the_loss(kind):
    if kind == "transformer":
        tm = _pair(j_tiny(), tiny_transformer_config())[1]  # its own model: the step trains it in place
    else:
        tm = _pair(j_tiny_hybrid(), tiny_hybrid_config())[1]
    cond, delayed, mask = TD.build_batch(tm, TD.synthetic_dataset(4), frames=16)
    params = {k: tm.params[k] for k in ("embeddings", "heads", "backbone")}
    opt = TT.make_optimizer(lr=3e-3, warmup=1)
    state = TT.init_train_state(params, opt)
    step = TT.build_train_step(tm.config, opt)
    losses = []
    for _ in range(5):
        state, loss = step(state, cond, delayed, mask)
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
