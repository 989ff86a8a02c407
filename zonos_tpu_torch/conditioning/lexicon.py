"""User pronunciation lexicon: word → IPA overrides (host-side).

Neither the reference nor stock eSpeak lets a deployment pin the
pronunciation of proper nouns ("Serana", "Dwemer", product names) without
rebuilding espeak dictionaries. This registry applies exact-word IPA
overrides BEFORE grapheme-to-phoneme conversion, for every G2P backend
(libespeak-ng, the native C++ engines, and the embedded readers): the text
is split on registered words (case-insensitive, word-boundary anchored) and
only the remaining segments go through the engine.

Entries can be global or per-language (a language-tagged entry wins over a
global one). The serving layer exposes this as POST/GET/DELETE /lexicon and
preloads entries from ``--lexicon file.json`` / ZONOS_LEXICON.

Thread-safe: the registry is read on every request and mutated by admin
calls; a simple lock plus copy-on-read keeps phonemize lock-free.
"""

from __future__ import annotations

import json
import re
import threading

_LOCK = threading.Lock()
# key: lowercased word; value: {language_or_"": ipa}
_ENTRIES: dict[str, dict[str, str]] = {}
_PATTERN: re.Pattern | None = None


def _rebuild_pattern() -> None:
    global _PATTERN
    if not _ENTRIES:
        _PATTERN = None
        return
    words = sorted(_ENTRIES, key=len, reverse=True)
    _PATTERN = re.compile(
        r"(?<![\w])(" + "|".join(re.escape(w) for w in words) + r")(?![\w])",
        re.IGNORECASE,
    )


def set_entries(entries: dict[str, str], language: str | None = None) -> int:
    """Register word → IPA overrides; returns the total entry count."""
    lang_key = (language or "").lower()
    with _LOCK:
        for word, ipa in entries.items():
            w = word.strip().lower()
            if not w or not ipa or not ipa.strip():
                continue
            _ENTRIES.setdefault(w, {})[lang_key] = ipa.strip()
        _rebuild_pattern()
        return len(_ENTRIES)


def remove(words: list[str] | None = None) -> int:
    """Remove specific words, or everything when words is None."""
    with _LOCK:
        if words is None:
            _ENTRIES.clear()
        else:
            for w in words:
                _ENTRIES.pop(w.strip().lower(), None)
        _rebuild_pattern()
        return len(_ENTRIES)


def entries() -> dict[str, dict[str, str]]:
    with _LOCK:
        return {w: dict(v) for w, v in _ENTRIES.items()}


def load_file(path: str) -> int:
    """Load a JSON lexicon file.

    Accepts either a flat {"word": "ipa"} object (global entries) or
    {"language": {"word": "ipa"}} nesting ("*" = global).
    """
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    total = 0
    if data and all(isinstance(v, dict) for v in data.values()):
        for lang, ent in data.items():
            total = set_entries(ent, None if lang in ("*", "") else lang)
    else:
        total = set_entries(data)
    return total


def _lookup(word: str, language: str) -> str | None:
    forms = _ENTRIES.get(word.lower())
    if not forms:
        return None
    lang = language.lower()
    # exact tag → base tag ("en-us" → "en") → global
    for key in (lang, lang.split("-")[0], ""):
        if key in forms:
            return forms[key]
    return None


def split(text: str, language: str) -> list[tuple[bool, str]] | None:
    """Split text into (is_ipa, payload) segments, or None when no
    registered word occurs (the common fast path)."""
    pat = _PATTERN
    if pat is None or not pat.search(text):
        return None
    out: list[tuple[bool, str]] = []
    pos = 0
    for m in pat.finditer(text):
        ipa = _lookup(m.group(0), language)
        if ipa is None:
            continue  # word registered only for other languages
        if m.start() > pos:
            out.append((False, text[pos:m.start()]))
        out.append((True, ipa))
        pos = m.end()
    if pos == 0:
        return None
    if pos < len(text):
        out.append((False, text[pos:]))
    return out
