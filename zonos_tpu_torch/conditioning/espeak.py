"""Grapheme → phoneme conversion (host-side).

The reference drives the eSpeak NG C library through the ``phonemizer``
package (the reference's zonos/conditioning.py:291-335). Here we bind
libespeak-ng directly via ctypes when it is present on the host —
no wrapper package needed — and fall back to a grapheme pass-through when it
isn't (letters are part of the model's symbol table, reference
conditioning.py:230-236, so grapheme input is representable; quality is
degraded but the pipeline stays functional for development and testing).

eSpeak NG is NOT thread-safe; all calls are serialized behind a module lock
(SURVEY.md §7.3 item 6).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
import threading

from zonos_tpu_torch.conditioning.text import clean

_LOCK = threading.Lock()
_LIB = None
_INITIALIZED = False
_SEARCHED = False
_CURRENT_VOICE: str | None = None

# espeak_TextToPhonemes phoneme modes: bit0 = include ties/ZWJ, bits 4-7
# separator. mode 0x02 → IPA output.
_PHONEME_MODE_IPA = 0x02
_TEXT_MODE_UTF8 = 1


def _find_library() -> str | None:
    for name in ("espeak-ng", "espeak"):
        path = ctypes.util.find_library(name)
        if path:
            return path
    for path in (
        os.environ.get("PHONEMIZER_ESPEAK_LIBRARY", ""),
        "/usr/lib/x86_64-linux-gnu/libespeak-ng.so.1",
        "/usr/local/lib/libespeak-ng.so",
    ):
        if path and os.path.exists(path):
            return path
    return None


def _load() -> "ctypes.CDLL | None":
    global _LIB, _INITIALIZED, _SEARCHED
    if _LIB is not None or _SEARCHED:
        return _LIB
    # Searched once per process: find_library spawns ldconfig/gcc, tens of ms
    # per call, which a miss would otherwise pay on every phonemize call.
    _SEARCHED = True
    path = _find_library()
    if path is None:
        return None
    lib = ctypes.cdll.LoadLibrary(path)
    # espeak_Initialize(AUDIO_OUTPUT_SYNCHRONOUS=1? we use 0x02 RETRIEVAL? —
    # phoneme-only use wants AUDIO_OUTPUT_PLAYBACK off; 0x01 = SYNCH playback.
    # Use AUDIO_OUTPUT_RETRIEVAL (1) with null callback: no audio generated.
    lib.espeak_Initialize.restype = ctypes.c_int
    rate = lib.espeak_Initialize(1, 0, None, 0)
    if rate <= 0:
        return None
    lib.espeak_TextToPhonemes.restype = ctypes.c_char_p
    lib.espeak_TextToPhonemes.argtypes = [
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.espeak_SetVoiceByName.restype = ctypes.c_int
    lib.espeak_SetVoiceByName.argtypes = [ctypes.c_char_p]
    _LIB = lib
    _INITIALIZED = True
    return lib


def espeak_available() -> bool:
    with _LOCK:
        return _load() is not None


def _phonemize_one(lib, text: str, language: str) -> str:
    global _CURRENT_VOICE
    if _CURRENT_VOICE != language:
        if lib.espeak_SetVoiceByName(language.encode()) != 0:
            # Retry with the base language code ("en-us" → "en").
            lib.espeak_SetVoiceByName(language.split("-")[0].encode())
        _CURRENT_VOICE = language
    buf = ctypes.create_string_buffer(text.encode("utf-8"))
    ptr = ctypes.c_void_p(ctypes.addressof(buf))
    pieces = []
    # espeak advances the pointer across clause boundaries; loop until done.
    while ptr.value:
        out = lib.espeak_TextToPhonemes(
            ctypes.byref(ptr), _TEXT_MODE_UTF8, _PHONEME_MODE_IPA
        )
        if out is None:
            break
        pieces.append(out.decode("utf-8", errors="ignore"))
    return " ".join(p.strip() for p in pieces if p.strip())


def _engine_one(t: str, lang: str) -> str:
    """One cleaned text → IPA via the backend chain (no lexicon handling)."""
    with _LOCK:
        lib = _load()
        if lib is not None:
            return _phonemize_one(lib, t, lang)

    from zonos_tpu_torch.conditioning import native_g2p
    from zonos_tpu_torch.conditioning.kana import has_kana, kana_to_ipa

    ipa = native_g2p.phonemize(t, lang)
    if ipa is None and lang.startswith("ja") and has_kana(t):
        ipa = kana_to_ipa(t)
    if ipa is None and lang[:3] == "yue":
        from zonos_tpu_torch.conditioning.yue import cantonese_to_ipa

        ipa = cantonese_to_ipa(t)
    elif ipa is None and lang[:3] in ("cmn", "hak") or ipa is None and lang[:2] == "zh":
        from zonos_tpu_torch.conditioning.zh import chinese_to_ipa

        ipa = chinese_to_ipa(t, lang)
    if (ipa is None or not ipa.strip()) and t.strip():
        # None = no engine for the language; empty = the engine dropped
        # every byte (e.g. script mismatch). Both degrade to graphemes
        # and both must be loud.
        _warn_grapheme_fallback(lang)
        ipa = None
    return ipa if ipa else t.lower()


def phonemize(texts: list[str], languages: list[str]) -> list[str]:
    """Clean + phonemize a batch (reference conditioning.py:307-335).

    Backend order: libespeak-ng (all 109 languages) → native C++ rule engines
    (native/zonos_text — 93 language codes across 19 scripts, with
    lexicon + stress marks; see docs/LANGUAGES.md) → embedded ja/zh/yue readers →
    lowercase graphemes (representable in the model symbol table, degraded
    quality — logged once per language so the degradation is loud, not
    silent).

    Registered pronunciation overrides (conditioning/lexicon.py — proper
    nouns with hand-written IPA) are spliced in before any backend runs,
    so they hold for espeak and the native engines alike.
    """
    from zonos_tpu_torch.conditioning import lexicon

    texts = clean(texts, languages)
    out = []
    for t, lang in zip(texts, languages):
        segments = lexicon.split(t, lang)
        if segments is None:
            out.append(_engine_one(t, lang))
            continue
        pieces = []
        for is_ipa, payload in segments:
            if is_ipa:
                pieces.append(payload)
            else:
                converted = _engine_one(payload, lang)
                if converted.strip():
                    pieces.append(converted.strip())
        out.append(" ".join(pieces))
    return out


_WARNED_LANGS: set[str] = set()


def _warn_grapheme_fallback(lang: str) -> None:
    """One loud log line per language when G2P degrades to graphemes."""
    if lang in _WARNED_LANGS:
        return
    _WARNED_LANGS.add(lang)
    import logging

    logging.getLogger("zonos_tpu_torch").warning(
        "no G2P backend for %r (espeak-ng absent, no native rule set): "
        "falling back to lowercase graphemes — intelligibility will degrade",
        lang,
    )
