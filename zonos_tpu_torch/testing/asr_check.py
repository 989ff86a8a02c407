"""ASR round trip of generated audio (port of ``zonos_tpu/testing/asr_check.py``).

Generated speech is transcribed with ``transformers``' Whisper
(``openai/whisper-tiny.en``) when both the package and the weights are in the
local Hugging Face cache; nothing is downloaded. Otherwise ``transcribe``
returns None, so the check degrades instead of failing where neither is
installed. Whisper runs on the card unless the caller passes ``device``.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np

logger = logging.getLogger("zonos_tpu_torch")

ASR_MODEL = "openai/whisper-tiny.en"

_ASR = None
_ASR_FAILED = False


@dataclass
class TranscriptionResult:
    text: str
    words: list[tuple[str, float, float]]  # (word, start_s, end_s)


def _load_asr():
    """(processor, model) from the local cache, once per process; None when absent."""
    global _ASR, _ASR_FAILED
    if _ASR is not None or _ASR_FAILED:
        return _ASR
    from zonos_tpu_torch.utils.hub import repo_dir

    snapshots = repo_dir(ASR_MODEL) / "snapshots"
    if not snapshots.is_dir():  # no weights to load: spare the import of transformers (~15 s)
        logger.info(f"ASR verification unavailable: no {snapshots}")
        _ASR_FAILED = True
        return None
    try:
        from transformers import WhisperForConditionalGeneration, WhisperProcessor

        proc = WhisperProcessor.from_pretrained(ASR_MODEL, local_files_only=True)
        model = WhisperForConditionalGeneration.from_pretrained(ASR_MODEL, local_files_only=True)
        model.eval()
        _ASR = (proc, model)
    except Exception as e:  # no transformers, or no local weights
        logger.info(f"ASR verification unavailable: {e}")
        _ASR_FAILED = True
    return _ASR


def transcribe(wav: np.ndarray, sample_rate: int, device=None) -> TranscriptionResult | None:
    """Transcribe mono (or [C, T], averaged) audio on ``device`` (default: the
    card, which raises without one); None when no ASR is available."""
    import torch

    from zonos_tpu_torch import resolve_device
    from zonos_tpu_torch.audio.resample import resample_poly

    device = resolve_device(device)
    asr = _load_asr()
    if asr is None:
        return None
    proc, model = asr
    model.to(device)  # in place: the cached model follows the last caller's device
    wav = np.asarray(wav, np.float32)
    if wav.ndim == 2:
        wav = wav.mean(axis=0)
    if sample_rate != 16000:
        wav = resample_poly(wav, sample_rate, 16000)
    inputs = proc(wav, sampling_rate=16000, return_tensors="pt")
    with torch.no_grad():
        ids = model.generate(inputs.input_features.to(device), max_new_tokens=200)
    text = proc.batch_decode(ids, skip_special_tokens=True)[0].strip()
    return TranscriptionResult(text=text, words=[])


def word_overlap(expected: str, transcribed: str) -> float:
    """Share of the expected words found in the transcription (order-free)."""
    def norm(s):
        return [w.strip(".,!?;:\"'").lower() for w in s.split() if w.strip(".,!?;:\"'")]

    exp, got = norm(expected), set(norm(transcribed))
    if not exp:
        return 1.0
    return sum(1 for w in exp if w in got) / len(exp)


def plot_waveform(wav: np.ndarray, sample_rate: int, out_path: str, words=None) -> None:
    """Waveform plot with an optional word-boundary overlay (needs matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    wav = np.asarray(wav)
    if wav.ndim == 2:
        wav = wav.mean(axis=0)
    t = np.arange(wav.shape[0]) / sample_rate
    fig, ax = plt.subplots(figsize=(12, 3))
    ax.plot(t, wav, linewidth=0.4)
    if words:
        for word, start, _end in words:
            ax.axvline(start, color="tab:orange", alpha=0.5, linewidth=0.6)
            ax.text(start, ax.get_ylim()[1] * 0.9, word, fontsize=7, rotation=45)
    ax.set_xlabel("seconds")
    fig.tight_layout()
    fig.savefig(out_path, dpi=100)
    plt.close(fig)
