"""The port's text front end, make_cond_dict and prefix conditioning against the
JAX package's, on the tiny config at float32.

The port phonemizes through its own copy of the front end and its own build
of the native G2P library (built by g++ into zonos_tpu_torch/build/ at first
use); the phonemes must be identical strings for every language tried.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zonos_tpu.conditioning import espeak as JE
from zonos_tpu.conditioning import lexicon as JL
from zonos_tpu.conditioning.cond_dict import make_cond_dict as j_make_cond_dict
from zonos_tpu.conditioning.conditioners import prefix_conditioner_forward as j_prefix
from zonos_tpu.conditioning.text import tokenize_phonemes as j_tokenize
from zonos_tpu.config import tiny_transformer_config as j_tiny
from zonos_tpu.models.zonos import Zonos as JZonos
from zonos_tpu_torch.bridge import params_from_jax
from zonos_tpu_torch.conditioning import espeak as TE
from zonos_tpu_torch.conditioning import lexicon as TL
from zonos_tpu_torch.conditioning import native_g2p
from zonos_tpu_torch.conditioning.cond_dict import make_cond_dict
from zonos_tpu_torch.conditioning.conditioners import prefix_conditioner_forward
from zonos_tpu_torch.conditioning.text import tokenize_phonemes
from zonos_tpu_torch.config import tiny_transformer_config
from zonos_tpu_torch.models.zonos import ConditioningCache, Zonos

SPEAKER = np.random.default_rng(0).normal(size=(1, 1, 128)).astype(np.float32)

TEXTS = [
    ("en-us", "On May 3rd, 2024 I paid $12.50 for 3 books."),
    ("de", "Ich habe 25 Äpfel gekauft."),
    ("fr-fr", "Il y a 21 élèves dans la classe."),
    ("ru", "У меня 3 кошки и собака."),
    ("ja", "今日は3月です。ありがとう"),
    ("cmn", "我有3本书。"),
    ("yue", "我哋今日去飲茶。"),
]


@pytest.fixture(scope="module")
def models():
    jm = JZonos.from_config(j_tiny(), seed=0, dtype=jnp.float32)
    port = Zonos(tiny_transformer_config(), params_from_jax(jax.tree.map(np.asarray, jm.params)),
                 dtype=torch.float32, device="cpu")
    return jm, port


def _assert_dicts_equal(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        if isinstance(ref[k], np.ndarray):
            assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
            np.testing.assert_array_equal(got[k], ref[k])
        else:
            assert got[k] == ref[k], k


@pytest.mark.parametrize("kwargs", [
    {},
    dict(text="Bonjour", language="fr-fr", speaker=SPEAKER, emotion=[1, 0, 0, 0, 0, 0, 0, 1], fmax=24000.0,
         pitch_std=45.0, speaking_rate=12.0, vqscore_8=[0.7] * 8, ctc_loss=0.1, dnsmos_ovrl=3.5,
         speaker_noised=True, unconditional_keys={"emotion"}),
])
def test_make_cond_dict_equal(kwargs):
    _assert_dicts_equal(make_cond_dict(**kwargs), j_make_cond_dict(**kwargs))


def test_native_g2p_builds_into_the_port_build_dir():
    assert native_g2p.available()
    path = native_g2p.library_path()
    assert path.exists() and path.parent.name == "build" and path.parent.parent.name == "zonos_tpu_torch"


@pytest.mark.parametrize("language,text", TEXTS, ids=[lang for lang, _ in TEXTS])
def test_phonemize_identical(language, text):
    got = TE.phonemize([text], [language])
    assert got == JE.phonemize([text], [language])
    assert got[0].strip() and got[0] != text.lower()  # a G2P engine ran, not the grapheme fallback


def test_phonemize_with_lexicon_override_identical():
    override = {"Zonos": "zˈoʊnoʊs"}
    JL.set_entries(override, "en-us")
    TL.set_entries(override, "en-us")
    try:
        text = "Zonos speaks 2 languages."
        got = TE.phonemize([text], ["en-us"])
        assert got == JE.phonemize([text], ["en-us"])
        assert "zˈoʊnoʊs" in got[0]
    finally:
        JL.remove(["Zonos"])
        TL.remove(["Zonos"])


def test_tokenize_phonemes_identical():
    phonemes = ["həlˈoʊ wˈɜːld", "ɪt wʊd", "ʃ🙂x"]  # an unknown symbol maps to UNK
    assert tokenize_phonemes(phonemes) == j_tokenize(phonemes)


def _close(got: torch.Tensor, ref) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["full", "missing_optional"])
def test_prefix_conditioner_matches(models, case):
    jm, port = models
    cd = make_cond_dict(text="Hello world.", speaker=SPEAKER)
    if case == "missing_optional":  # dropped keys take the learned uncond vectors
        cd = {k: cd[k] for k in ("espeak", "emotion", "language_id")}
    # non-zero uncond vectors, so taking one is visible
    for name in ("speaker", "fmax", "pitch_std"):
        vec = np.linspace(-1, 1, 64).astype(np.float32) * (1 + len(name))
        jm.params["prefix_conditioner"][name]["uncond_vector"] = jnp.asarray(vec)
        port.params["prefix_conditioner"][name]["uncond_vector"] = torch.from_numpy(vec)
    ref = j_prefix(jm.params["prefix_conditioner"], jm.config.prefix_conditioner, cd, jnp.float32)
    got = prefix_conditioner_forward(port.params["prefix_conditioner"], port.config.prefix_conditioner, cd,
                                     torch.float32)
    assert got.shape == ref.shape
    _close(got, ref)


@pytest.mark.parametrize("cfg_scale", [2.0, 1.0])
def test_prepare_conditioning_matches(models, cfg_scale):
    jm, port = models
    cd = make_cond_dict(text="Two point oh.", speaker=SPEAKER)
    ref = jm.prepare_conditioning(cd, cfg_scale=cfg_scale)
    got = port.prepare_conditioning(cd, cfg_scale=cfg_scale)
    assert got.shape == ref.shape and got.shape[0] == (2 if cfg_scale != 1.0 else 1)
    _close(got, ref)


def test_conditioning_cache_hit_and_key(models):
    jm, port = models
    port._conditioning_cache.clear()
    cd = make_cond_dict(text="Cached.", speaker=SPEAKER)
    first = port.prepare_conditioning(cd, use_cache=True)
    assert port._conditioning_cache.size() == 1
    hit = port.prepare_conditioning(cd, use_cache=True)
    assert hit is first and port._conditioning_cache.size() == 1
    _close(hit, jm.prepare_conditioning(cd, use_cache=True))
    assert ConditioningCache.make_key(cd, None, 2.0) != ConditioningCache.make_key(cd, None, 1.0)
    one = port.prepare_conditioning(cd, use_cache=True, cfg_scale=1.0)
    assert one.shape[0] == 1 and port._conditioning_cache.size() == 2
