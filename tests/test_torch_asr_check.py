"""The port's ASR check (``zonos_tpu_torch/testing/asr_check.py``) against the
JAX package's: ``word_overlap`` equal on the same strings, ``transcribe``
None where Whisper is not in the local Hugging Face cache (nothing is
fetched), and ``plot_waveform`` writing a figure."""

import os

import numpy as np
import pytest

from zonos_tpu.testing import asr_check as J
from zonos_tpu_torch.testing import asr_check as T

PAIRS = [("hello world", "Hello, world!"), ("a b c d", "a c"), ("", "anything"), ("Well met, traveler.", ""),
         ("The road north; is it dangerous?", "the road is dangerous"), ("repeat repeat word", "repeat")]


@pytest.mark.parametrize("expected, transcribed", PAIRS)
def test_word_overlap_equals_jax(expected, transcribed):
    assert T.word_overlap(expected, transcribed) == J.word_overlap(expected, transcribed)


def test_transcribe_is_none_without_local_weights(monkeypatch, tmp_path):
    """An empty hub cache: the loader fails once, quietly, and stays failed."""
    for var in ("HF_HOME", "HF_HUB_CACHE"):
        monkeypatch.setenv(var, str(tmp_path / "hf"))
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setattr(T, "_ASR", None)
    monkeypatch.setattr(T, "_ASR_FAILED", False)
    wav = np.sin(np.linspace(0, 200, 44100, dtype=np.float32))
    assert T.transcribe(wav, 44100, device="cpu") is None
    assert T._ASR_FAILED and T.transcribe(np.stack([wav, wav]), 44100, device="cpu") is None


def test_plot_waveform(tmp_path):
    wav = np.sin(np.linspace(0, 50, 8000, dtype=np.float32))
    out = str(tmp_path / "w.png")
    T.plot_waveform(np.stack([wav, wav]), 16000, out, words=[("hi", 0.1, 0.2)])
    assert os.path.getsize(out) > 1000
