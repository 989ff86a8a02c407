"""Speaker and prefix audio preparation with persistent caching
(port of ``zonos_tpu/serving/audio_prep.py``).

A speaker wav becomes the [1, 1, 128] LDA speaker embedding, a prefix wav
the DAC codes [1, n_q, T] that the model continues; both are cached by file
stem in the same two-tier caches, and the same on-disk files, as the JAX
package's.
"""

from __future__ import annotations

import logging
import wave
from pathlib import Path

import numpy as np

from zonos_tpu_torch.audio.io import read_audio
from zonos_tpu_torch.serving.caches import get_embed_cache, get_prefix_cache

logger = logging.getLogger("zonos_tpu_torch")


def process_speaker_audio(
    speaker_path: str,
    model_name: str,
    use_cache: bool = True,
    speaker_model=None,
    device=None,
) -> np.ndarray:
    """wav file → [1, 1, 128] LDA speaker embedding, cached by file stem.

    Without ``speaker_model`` the shared ``default_speaker_model`` on
    ``device`` (default: the card) computes it.
    """
    key = Path(speaker_path).stem
    cache = get_embed_cache(model_name)
    if use_cache:
        hit = cache.get(key)
        if hit is not None:
            return hit

    from zonos_tpu_torch.speaker.embedding import default_speaker_model

    model = speaker_model or default_speaker_model(device)
    wav, sr = read_audio(speaker_path)
    _, lda = model(wav, sr)
    emb = lda[None, :, :].astype(np.float32)  # [1, 1, 128]
    if use_cache:
        cache.put(key, emb)
    return emb


def process_prefix_audio(
    prefix_path: str,
    autoencoder,
    use_cache: bool = True,
) -> np.ndarray:
    """wav file → DAC codes [1, n_q, T] for audio-prefix continuation, cached."""
    key = Path(prefix_path).stem
    cache = get_prefix_cache()
    if use_cache:
        hit = cache.get(key)
        if hit is not None:
            return hit

    wav, sr = read_audio(prefix_path)
    wav = wav.mean(axis=0) if wav.ndim == 2 else wav
    codes = autoencoder.encode(autoencoder.preprocess(wav[None, :], sr))
    if use_cache:
        cache.put(key, codes)
    return codes


def init_latent_cache(
    speakers_dir: str,
    model_name: str,
    speaker_model=None,
    device=None,
) -> int:
    """Precompute the speaker embedding of every wav under ``speakers_dir``.

    Returns the number of embeddings now warm. An unreadable file is logged
    and skipped; a missing card raises before any file is read.
    """
    count = 0
    d = Path(speakers_dir)
    if not d.is_dir():
        return 0
    if speaker_model is None:
        from zonos_tpu_torch.speaker.embedding import default_speaker_model

        speaker_model = default_speaker_model(device)
    for wav_path in sorted(d.glob("**/*.wav")):
        try:
            process_speaker_audio(str(wav_path), model_name, speaker_model=speaker_model)
            count += 1
        except (OSError, ValueError, EOFError, wave.Error) as e:
            logger.warning(f"speaker warm-cache failed for {wav_path}: {e}")
    logger.info(f"speaker latent cache warm: {count} embeddings")
    return count
