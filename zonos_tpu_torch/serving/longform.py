"""Long-form text chunking beyond the 30-second ceiling (copy of ``zonos_tpu/serving/longform.py``).

One generation is capped at 30 s of audio —
``max_new_tokens = clamp(86, 2 + len(text)·6.5, 2580)`` — so ``pipeline.tts``
splits long requests on sentence boundaries, generates each chunk with the
same conditioning (seed advanced per chunk), and concatenates the waveforms
with a short pause.
"""

from __future__ import annotations

import re

# ≈ 2340 tokens ≈ 27 s of audio: headroom under the 2580-token ceiling so a
# chunk's natural EOS, not the cap, ends it.
MAX_CHUNK_CHARS = 360

# Pause inserted between chunks (sentence gap), seconds.
CHUNK_GAP_S = 0.12

# Sentence enders: Latin + CJK + Arabic question mark + Devanagari danda.
_SENT_RE = re.compile(r"[^.!?…。！？؟۔।]+[.!?…。！？؟۔।]*\s*")
# Soft break points inside an oversized sentence.
_SOFT_RE = re.compile(r"[^,;:、，；：]+[,;:、，；：]*\s*")


def split_sentences(text: str) -> list[str]:
    """Split into sentences, keeping the terminators and trailing space."""
    return [m.group(0) for m in _SENT_RE.finditer(text) if m.group(0).strip()]


def _split_oversized(piece: str, max_chars: int) -> list[str]:
    """A single sentence longer than max_chars: break at soft punctuation,
    then at whitespace as a last resort."""
    if len(piece) <= max_chars:
        return [piece]
    parts = [m.group(0) for m in _SOFT_RE.finditer(piece) if m.group(0).strip()]
    out: list[str] = []
    for part in parts:
        while len(part) > max_chars:
            cut = part.rfind(" ", 0, max_chars)
            if cut <= 0:
                cut = max_chars
            out.append(part[:cut])
            part = part[cut:].lstrip()
        if part:
            out.append(part)
    return out or [piece[:max_chars]]


def chunk_text(text: str, max_chars: int = 0) -> list[str]:
    """Greedy sentence packing into chunks of at most ``max_chars``."""
    limit = max_chars or MAX_CHUNK_CHARS
    pieces: list[str] = []
    for sent in split_sentences(text):
        pieces.extend(_split_oversized(sent, limit))
    chunks: list[str] = []
    cur = ""
    for piece in pieces:
        if cur and len(cur) + len(piece) > limit:
            chunks.append(cur.strip())
            cur = piece
        else:
            cur += piece
    if cur.strip():
        chunks.append(cur.strip())
    return chunks or [text]


def is_longform(text: str, max_chars: int = 0) -> bool:
    return len(text) > (max_chars or MAX_CHUNK_CHARS)
