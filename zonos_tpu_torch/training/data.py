"""Training data: (text, audio) pairs → model-ready batches (port of
``zonos_tpu/training/data.py``).

Featurization runs on the host and the model's device: phonemes and the
conditioners' forward (``Zonos.prepare_conditioning``, no CFG half), the DAC
encoder for raw audio, the delay pattern in numpy. Batches come back as
numpy arrays of fixed shapes (codes padded to ``frames`` with a loss mask),
as JAX's do; a background thread (``PrefetchLoader``) builds the next ones
while a step runs.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Iterator, Sequence

import numpy as np
import torch

from zonos_tpu_torch.conditioning.cond_dict import make_cond_dict
from zonos_tpu_torch.ops.delay_pattern import apply_delay_pattern_np


@dataclasses.dataclass
class TTSExample:
    text: str
    codes: np.ndarray  # [n_q, T] DAC codes
    language: str = "en-us"
    speaker: np.ndarray | None = None  # [1, 1, 128]


def encode_wav_example(autoencoder, text: str, wav: np.ndarray, sr: int, **kw) -> TTSExample:
    """Raw audio → its DAC codes (the port's encoder), as a training example."""
    pre = autoencoder.preprocess(np.atleast_2d(wav), sr)
    codes = np.asarray(autoencoder.encode(pre)[0], np.int32)
    return TTSExample(text=text, codes=codes, **kw)


def build_batch(model, examples: Sequence[TTSExample], frames: int,
                mask_token: int = 1025) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(cond_emb [B, Lc, D] f32, delayed_codes [B, n_q, frames + n_q], loss_mask [B, frames + n_q - 1]).

    Conditioning runs without CFG (training is teacher-forced on the
    conditional branch only). Codes right-pad with MASK beyond each sample's
    length; the loss mask covers only real next-frame targets.
    """
    b = len(examples)
    n_q = model.config.codebook_dimension
    zeros = np.zeros((1, 1, 128), np.float32)

    cd = make_cond_dict(text=examples[0].text, language=examples[0].language,
                        speaker=examples[0].speaker if examples[0].speaker is not None else zeros)
    cd["espeak"] = ([e.text for e in examples], [e.language for e in examples])
    if any(e.speaker is not None for e in examples):
        cd["speaker"] = np.concatenate([e.speaker if e.speaker is not None else zeros for e in examples], axis=0)
    cond = model.prepare_conditioning(cd, cfg_scale=1.0)
    cond = cond.detach().to(torch.float32).cpu().numpy()

    codes = np.full((b, n_q, frames), mask_token, np.int32)
    lengths = np.zeros((b,), np.int32)
    for i, e in enumerate(examples):
        t = min(e.codes.shape[-1], frames)
        codes[i, :, :t] = e.codes[:, :t]
        lengths[i] = t
    delayed = apply_delay_pattern_np(codes, mask_token)

    # Next-frame targets exist for delayed positions 1..; positions past each
    # sample's delayed length are masked out.
    pos = np.arange(delayed.shape[-1] - 1)[None, :]
    loss_mask = pos < (lengths[:, None] + n_q)
    return cond, delayed, loss_mask


def synthetic_dataset(n: int, n_q: int = 9, min_frames: int = 8, max_frames: int = 24,
                      seed: int = 0) -> list[TTSExample]:
    """Random-code dataset for tests and smoke runs (numpy's RNG: JAX's examples)."""
    rng = np.random.default_rng(seed)
    texts = ["hello world", "testing one two", "synthesized speech", "the quick fox"]
    out = []
    for i in range(n):
        t = int(rng.integers(min_frames, max_frames + 1))
        out.append(TTSExample(text=texts[i % len(texts)], codes=rng.integers(0, 1024, size=(n_q, t)).astype(np.int32)))
    return out


class PrefetchLoader:
    """Builds ``num_batches`` batches with ``batch_fn`` in a background thread,
    at most ``prefetch`` ahead of the consumer. An exception in ``batch_fn``
    is raised by the iterator."""

    def __init__(self, batch_fn: Callable[[], tuple], num_batches: int, prefetch: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._n = num_batches

        def worker():
            try:
                for _ in range(num_batches):
                    self._q.put(batch_fn())
            except BaseException as e:  # handed to the consumer
                self._q.put(e)
                return
            self._q.put(None)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self) -> Iterator[tuple]:
        while True:
            item = self._q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    def __len__(self) -> int:
        return self._n
