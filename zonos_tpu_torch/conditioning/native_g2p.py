"""ctypes loader for the native C++ G2P library (native/zonos_text), the port's own.

Build-on-demand: compiles ``native/zonos_text/g2p.cpp`` with g++ the first
time it is needed into ``zonos_tpu_torch/build/libzonos_text.<hash>.so``,
where the hash covers the source and the flags, so an edited source is
rebuilt and a stale library is never loaded. Nothing is written under
``native/``, and the JAX package's library is never loaded. Without a
compiler ``phonemize`` returns None and the caller's chain falls back.
Covers English (NRL-style rules + irregular lexicon + stress), Spanish,
German, Italian, French, Portuguese, Russian, Turkish, Polish, Dutch,
Czech, Romanian, Finnish, Hungarian, Greek, Korean, Indonesian/Malay,
Swahili, Ukrainian, Bulgarian, Croatian/Bosnian/Serbian-Latin/Slovene,
Slovak, Estonian, Azerbaijani, Esperanto, Basque, Macedonian, Georgian,
Armenian, Latvian, Welsh, Serbian in BOTH scripts (Cyrillic Vukovica and
Latin Gajica, script-sniffed), Vietnamese (tones dropped — no tone letters
in the model symbol table), Swedish/Norwegian/Danish, and the Brahmic
family through one ISCII-aligned decoder — Hindi/Marathi/Nepali
(Devanagari with schwa deletion), Bengali/Assamese, Punjabi, Gujarati,
Odia, Tamil (positional voicing), Telugu, Kannada, Malayalam — plus the
Perso-Arabic script for Persian (fa, fa-latn), Urdu and Arabic, and a
table-driven generic Latin engine for twenty regular orthographies
(mi la sq mt af is ca ht pap gn uz ku tn om ia lfn jbo lt kl an), Turkic
Cyrillic (kk ky tt ba) and the Ethiopic abugida for Amharic; other
languages go through eSpeak when present, else grapheme passthrough
(conditioning/espeak.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

_LOCK = threading.Lock()
_LIB = None
_TRIED = False

_ABI_VERSION = 21  # the C ABI and tables this module expects of g2p.cpp

SOURCE = Path(__file__).resolve().parents[2] / "native" / "zonos_text" / "g2p.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
CXX_FLAGS = ["-O2", "-fPIC", "-shared"]


def library_path() -> Path:
    """Where the library of the current source is (or will be) built."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libzonos_text.{digest.hexdigest()[:12]}.so"


def _build(out: Path) -> bool:
    gxx = shutil.which("g++")
    if gxx is None:
        logging.getLogger("zonos_tpu_torch").warning("g++ not found: the native G2P library cannot be built")
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        logging.getLogger("zonos_tpu_torch").warning(
            "g++ failed to build the native G2P library (exit %d):\n%s", proc.returncode, proc.stderr[-4000:])
        return False
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    return True


def _load():
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if not SOURCE.exists():
        return None
    out = library_path()
    if not out.exists() and not _build(out):
        return None
    lib = ctypes.CDLL(str(out))
    lib.ztx_version.restype = ctypes.c_int
    if lib.ztx_version() < _ABI_VERSION:
        raise RuntimeError(f"{SOURCE} has ABI {lib.ztx_version()}, this loader expects {_ABI_VERSION}")
    lib.ztx_phonemize_lang.restype = ctypes.c_void_p
    lib.ztx_phonemize_lang.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.ztx_free.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return _LIB


def available() -> bool:
    with _LOCK:
        return _load() is not None


# Languages written in a non-Latin script: their engines drop embedded
# Latin-alphabet runs (anglicized numbers from clean(), foreign names, ...).
# eSpeak speaks such runs by switching voices; we match that by reading them
# with the English rule engine and stitching the pieces back together.
_NON_LATIN_PREFIXES = (
    # NOT "sr": Serbian is digraphic — Latin (Gajica) input is native
    # text for its engine, and Cyrillic input is script-sniffed there.
    "ru", "uk", "bg", "mk", "kk", "ky", "tt", "ba", "be",
    "el", "grc", "ar", "fa", "ur", "sd", "he", "hi", "mr", "ne",
    "bn", "as", "bpy", "pa", "gu", "or", "ta", "te", "kn", "ml",
    "si", "my", "shn", "ka", "hy", "am", "ko", "kok",
)

_LATIN_RUN = re.compile(r"[A-Za-z][A-Za-z']*(?:[ -][A-Za-z][A-Za-z']*)*")


def _is_non_latin_lang(language: str) -> bool:
    if language.startswith("fa-latn"):
        return False  # romanized Persian IS Latin text
    base = language.split("-")[0]
    return base in _NON_LATIN_PREFIXES


def phonemize(text: str, language: str) -> str | None:
    """Text → IPA via the native rule engines; None if the language (or the
    library) is unavailable. Languages: en*, es*, de*, it*, fr*,
    pt*, ru*, tr*, pl*, nl*, cs*, ro*, fi*, hu*, el*, ko*, id*/ms*, sw*, uk*,
    bg*, hr*/bs*/sr*/sl* (sr in both scripts), sk*, et*, az*, eo*, eu*, mk*,
    ka*, hy*, lv*, cy*, vi*, sv*, nb*/nn*/no*, da*, hi*, mr*, ne*, bn*, as*,
    pa*, gu*, or*, ta*, te*, kn*, ml*, fa*, fa-latn, ur*, ar*, mi, la, sq,
    mt, af, is, ca, ht, pap, gn, uz, ku, tn, om, ia, lfn, jbo, lt, kl, an,
    kk, ky, tt, ba, am.

    For non-Latin-script languages, embedded Latin-letter runs (e.g. the
    anglicized numbers clean() emits, acronyms, foreign names) are read with
    the English engine instead of being dropped — the same behaviour as
    eSpeak's automatic language switching.
    """
    if _is_non_latin_lang(language) and _LATIN_RUN.search(text):
        pieces: list[str] = []
        pos = 0
        for m in _LATIN_RUN.finditer(text):
            if m.start() > pos:
                seg = _phonemize_raw(text[pos:m.start()], language)
                if seg is None:
                    return None
                pieces.append(seg)
            en = _phonemize_raw(m.group(0), "en")
            if en is None:
                return None
            pieces.append(en)
            pos = m.end()
        if pos < len(text):
            seg = _phonemize_raw(text[pos:], language)
            if seg is None:
                return None
            pieces.append(seg)
        return " ".join(p.strip() for p in pieces if p.strip())
    return _phonemize_raw(text, language)


def _phonemize_raw(text: str, language: str) -> str | None:
    with _LOCK:
        lib = _load()
        if lib is None:
            return None
        ptr = lib.ztx_phonemize_lang(text.encode("utf-8"), language.encode())
        if not ptr:
            return None
        try:
            return ctypes.string_at(ptr).decode("utf-8", errors="ignore")
        finally:
            lib.ztx_free(ptr)


def phonemize_en(text: str) -> str | None:
    """English text → IPA via the native rule engine; None if unavailable."""
    return phonemize(text, "en")
