"""Host-side audio file I/O without torchaudio/soundfile (copy of ``zonos_tpu/audio/io.py``).

WAV via the stdlib ``wave`` module (PCM16/24/32 + float32); other container
formats (mp3 etc.) via an ``ffmpeg`` CLI fallback when present on the host.
"""

from __future__ import annotations

import io
import os
import shutil
import struct
import subprocess
import wave

import numpy as np


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a WAV file → (float32 [channels, T] in [-1, 1], sample_rate)."""
    with open(path, "rb") as f:
        data = f.read()
    return _decode_wav_bytes(data)


def _decode_wav_bytes(data: bytes) -> tuple[np.ndarray, int]:
    # Peek the fmt chunk to detect IEEE-float wavs (stdlib wave rejects them).
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    fmt_code, bits = None, None
    pos = 12
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        size = struct.unpack("<I", data[pos + 4 : pos + 8])[0]
        if cid == b"fmt ":
            fmt_code = struct.unpack("<H", data[pos + 8 : pos + 10])[0]
            bits = struct.unpack("<H", data[pos + 22 : pos + 24])[0]
        pos += 8 + size + (size & 1)

    if fmt_code == 3:  # IEEE float
        return _decode_float_wav(data)

    with wave.open(io.BytesIO(data)) as w:
        sr = w.getframerate()
        ch = w.getnchannels()
        sw = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if sw == 2:
        arr = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif sw == 4:
        arr = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
    elif sw == 3:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        vals = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
        arr = vals.astype(np.float32) / float(1 << 23)
    elif sw == 1:
        arr = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {sw}")
    return arr.reshape(-1, ch).T.copy(), sr


def _decode_float_wav(data: bytes) -> tuple[np.ndarray, int]:
    pos = 12
    sr, ch, payload = None, None, None
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        size = struct.unpack("<I", data[pos + 4 : pos + 8])[0]
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            ch = struct.unpack("<H", body[2:4])[0]
            sr = struct.unpack("<I", body[4:8])[0]
        elif cid == b"data":
            payload = body
        pos += 8 + size + (size & 1)
    arr = np.frombuffer(payload, "<f4").astype(np.float32)
    return arr.reshape(-1, ch).T.copy(), sr


def write_wav(path: str, wav: np.ndarray, sample_rate: int) -> None:
    """Write float [-1,1] or int16 audio ([T], [C,T] or [T,C]) as PCM16 WAV."""
    wav = np.asarray(wav)
    if wav.ndim == 1:
        wav = wav[None, :]
    if wav.shape[0] > wav.shape[1]:  # [T, C] → [C, T]
        wav = wav.T
    if wav.dtype != np.int16:
        wav = np.clip(wav * 32767.0, -32767.0, 32767.0).astype(np.int16)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with wave.open(path, "wb") as w:
        w.setnchannels(wav.shape[0])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(wav.T.tobytes())


def read_audio(path: str) -> tuple[np.ndarray, int]:
    """Read any audio file: WAV natively, everything else via ffmpeg."""
    if path.lower().endswith(".wav"):
        return read_wav(path)
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise RuntimeError(f"cannot decode {path}: ffmpeg not available on host")
    out = subprocess.run(
        [ffmpeg, "-v", "quiet", "-i", path, "-f", "wav", "-acodec", "pcm_s16le", "-"],
        capture_output=True,
        check=True,
    ).stdout
    return _decode_wav_bytes(out)
