"""SpeakerEmbeddingLDA: wav → (256-d embedding, 128-d LDA embedding)
(port of ``zonos_tpu/speaker/embedding.py``).

mono mix → resample to 16 kHz → zero-pad to a frame bucket → log-fbank →
ResNet293 → ASP → 256-d → LDA 128-d. The model consumes the LDA output
shaped [1, 1, 128]. The checkpoints (``ResNet293_SimAM_ASP_base.pt`` and its
``_LDA-128.pt``) are read from local paths with ``torch.load(weights_only=True)``;
nothing is downloaded. Without them the tower is a seeded random init.
"""

from __future__ import annotations

import functools
import logging

import numpy as np
import torch

from zonos_tpu_torch import resolve_device
from zonos_tpu_torch.audio.resample import resample_poly
from zonos_tpu_torch.speaker.fbank import log_fbank
from zonos_tpu_torch.speaker.resnet import (
    init_speaker_params,
    speaker_encoder_forward,
    speaker_state_dict_to_params,
)
from zonos_tpu_torch.utils.hub import cached_snapshot

logger = logging.getLogger("zonos_tpu_torch")

REPO_ID = "Zyphra/Zonos-v0.1-speaker-embedding"
CKPT_NAME = "ResNet293_SimAM_ASP_base.pt"
LDA_NAME = "ResNet293_SimAM_ASP_base_LDA-128.pt"


def _load_state_dict(path: str) -> dict:
    return torch.load(path, weights_only=True, map_location="cpu")


class SpeakerEmbeddingLDA:
    """Speaker tower + LDA on one device; numpy in and out at the boundary."""

    SAMPLE_RATE = 16_000

    def __init__(
        self,
        params: dict | None = None,
        lda: dict | None = None,
        ckpt_path: str | None = None,
        lda_ckpt_path: str | None = None,
        frame_bucket: int = 256,
        device=None,
    ):
        """``params``/``lda`` in the port's layout (LDA ``{"w": [128, 256], "b"}``),
        or checkpoint paths, or neither: a random init from seed 0 (the tower)
        and seed 1 (the LDA)."""
        self.device = resolve_device(device)
        if params is None and ckpt_path is not None:
            params = speaker_state_dict_to_params(_load_state_dict(ckpt_path), device=self.device)
        if lda is None and lda_ckpt_path is not None:
            sd = _load_state_dict(lda_ckpt_path)
            lda = {"w": sd["weight"].to(self.device, torch.float32), "b": sd["bias"].to(self.device, torch.float32)}
        if params is None:
            params = init_speaker_params(torch.Generator(device=self.device).manual_seed(0), device=self.device)
        if lda is None:
            gen = torch.Generator(device=self.device).manual_seed(1)
            lda = {"w": torch.randn((128, 256), generator=gen, device=self.device) * 0.05,
                   "b": torch.zeros((128,), device=self.device)}
        self.params = params
        self.lda = lda
        self.frame_bucket = frame_bucket

    def _bucket_pad(self, wav: np.ndarray) -> np.ndarray:
        """Zero-pad (or cut) to a bucketed sample count, as the JAX package does
        so that its jit compiles once per bucket; the same padding here keeps
        the embeddings equal to JAX's."""
        hop = 160
        n = wav.shape[-1]
        frames = 1 + n // hop
        bucket_frames = max(self.frame_bucket, ((frames + self.frame_bucket - 1) // self.frame_bucket) * self.frame_bucket)
        target = (bucket_frames - 1) * hop
        if n >= target:
            return wav[..., :target]
        return np.pad(wav, [(0, 0)] * (wav.ndim - 1) + [(0, target - n)])

    @torch.no_grad()
    def embed_device(self, wav: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Bucketed 16 kHz wav [B, T] on the device → (emb [B, 256], lda [B, 128])."""
        emb = speaker_encoder_forward(self.params, log_fbank(wav))
        return emb, emb @ self.lda["w"].T + self.lda["b"]

    def __call__(self, wav: np.ndarray, sample_rate: int) -> tuple[np.ndarray, np.ndarray]:
        """wav [C, T] or [T] → (emb [1, 256], lda_emb [1, 128])."""
        wav = np.asarray(wav, np.float32)
        if wav.ndim == 2:
            wav = wav.mean(axis=0)
        if sample_rate != self.SAMPLE_RATE:
            wav = resample_poly(wav, sample_rate, self.SAMPLE_RATE)
        wav = self._bucket_pad(wav[None, :])
        emb, lda_emb = self.embed_device(torch.as_tensor(wav, device=self.device))
        return emb.cpu().numpy(), lda_emb.cpu().numpy()


def _cached_checkpoints() -> tuple[str, str] | None:
    """The two checkpoints in a local Hugging Face hub cache, if present (``utils.hub``)."""
    snap = cached_snapshot(REPO_ID, (CKPT_NAME, LDA_NAME))
    return None if snap is None else (str(snap / CKPT_NAME), str(snap / LDA_NAME))


def default_speaker_model(device=None, ckpt_path: str | None = None,
                          lda_ckpt_path: str | None = None) -> SpeakerEmbeddingLDA:
    """One shared instance per device: the given local checkpoints, else those
    of a local hub cache, else a seeded random tower (with a warning)."""
    return _default_speaker_model(resolve_device(device), ckpt_path, lda_ckpt_path)


@functools.lru_cache(maxsize=4)
def _default_speaker_model(device: torch.device, ckpt_path, lda_ckpt_path) -> SpeakerEmbeddingLDA:
    if ckpt_path is None or lda_ckpt_path is None:
        cached = _cached_checkpoints()
        if cached is not None:
            ckpt_path, lda_ckpt_path = cached
    if ckpt_path is not None and lda_ckpt_path is not None:
        return SpeakerEmbeddingLDA(ckpt_path=ckpt_path, lda_ckpt_path=lda_ckpt_path, device=device)
    logger.warning("no local %s checkpoint: the speaker embedding uses a random tower (seed 0)", REPO_ID)
    return SpeakerEmbeddingLDA(device=device)


def make_speaker_embedding(wav: np.ndarray, sample_rate: int, device=None) -> np.ndarray:
    """wav → the model's speaker conditioning, [1, 1, 128] float32."""
    _, lda_emb = default_speaker_model(device)(wav, sample_rate)
    return lda_emb[None, :, :].astype(np.float32)
