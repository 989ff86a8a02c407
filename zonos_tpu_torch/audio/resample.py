"""Host-side polyphase resampling with scipy (copy of ``zonos_tpu/audio/resample.py``)."""

from __future__ import annotations

import math

import numpy as np
from scipy import signal


def resample_poly(wav: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Resample along the last axis using scipy's polyphase filter."""
    if orig_sr == target_sr:
        return wav
    g = math.gcd(int(orig_sr), int(target_sr))
    up, down = target_sr // g, orig_sr // g
    return signal.resample_poly(wav, up, down, axis=-1).astype(np.float32)
