"""Log-mel filterbank features for the speaker encoder (port of ``zonos_tpu/speaker/fbank.py``).

16 kHz, n_fft 512, a 400-sample periodic Hann window zero-padded to n_fft,
centred STFT with reflect padding, hop 160, 80 HTK-scale mel bands on the
power spectrum, then ``log1p`` and the per-utterance mean over time removed.
The JAX package leaves this to XLA; here it is plain PyTorch (``unfold`` into
frames, ``torch.fft.rfft``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=4)
def mel_filterbank(
    n_freqs: int = 257,
    n_mels: int = 80,
    sample_rate: int = 16000,
    f_min: float = 0.0,
    f_max: float | None = None,
) -> np.ndarray:
    """HTK-scale triangular mel filterbank [n_freqs, n_mels], no normalization
    (torchaudio defaults: mel_scale='htk', norm=None)."""
    f_max = f_max or sample_rate / 2
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    mel_pts = np.linspace(_hz_to_mel(f_min), _hz_to_mel(f_max), n_mels + 2)
    f_pts = _mel_to_hz(mel_pts)
    f_diff = np.diff(f_pts)  # [n_mels + 1]
    slopes = f_pts[None, :] - all_freqs[:, None]  # [n_freqs, n_mels + 2]
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    return fb.astype(np.float32)


def _window(n_fft: int, win_length: int) -> np.ndarray:
    window = np.hanning(win_length + 1)[:-1].astype(np.float32)  # periodic Hann
    lpad = (n_fft - win_length) // 2
    return np.pad(window, (lpad, n_fft - win_length - lpad))


def log_fbank(
    wav: torch.Tensor,  # [B, T] float32, 16 kHz
    n_fft: int = 512,
    win_length: int = 400,
    hop_length: int = 160,
    n_mels: int = 80,
    sample_rate: int = 16000,
) -> torch.Tensor:
    """Returns [B, n_mels, frames] float32, log1p and mean-normalized over time."""
    pad = n_fft // 2
    x = F.pad(wav.float()[:, None], (pad, pad), mode="reflect")[:, 0]
    window = torch.as_tensor(_window(n_fft, win_length), device=wav.device)
    frames = x.unfold(-1, n_fft, hop_length) * window  # [B, frames, n_fft]
    power = torch.fft.rfft(frames, dim=-1).abs().square()  # [B, frames, n_freqs]
    fb = torch.as_tensor(mel_filterbank(n_fft // 2 + 1, n_mels, sample_rate), device=wav.device)
    out = torch.log1p(power @ fb).transpose(1, 2)  # [B, n_mels, frames]
    return out - out.mean(dim=2, keepdim=True)
