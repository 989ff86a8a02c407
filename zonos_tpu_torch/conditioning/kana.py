"""Kana → IPA fallback for Japanese text (host-side).

Used when neither eSpeak NG nor sudachipy is available: hiragana/katakana
(including digraphs, sokuon and long vowels) map deterministically to IPA.
Kanji cannot be read without a dictionary and are dropped (the reference
requires sudachipy for readings, conditioning.py:256-260 — install it or
espeak-ng for full Japanese support).
"""

from __future__ import annotations

_BASE = {
    # vowels
    "あ": "a", "い": "i", "う": "ɯ", "え": "e", "お": "o",
    # k/g
    "か": "ka", "き": "ki", "く": "kɯ", "け": "ke", "こ": "ko",
    "が": "ɡa", "ぎ": "ɡi", "ぐ": "ɡɯ", "げ": "ɡe", "ご": "ɡo",
    # s/z
    "さ": "sa", "し": "ɕi", "す": "sɯ", "せ": "se", "そ": "so",
    "ざ": "za", "じ": "dʑi", "ず": "zɯ", "ぜ": "ze", "ぞ": "zo",
    # t/d
    "た": "ta", "ち": "tɕi", "つ": "tsɯ", "て": "te", "と": "to",
    "だ": "da", "ぢ": "dʑi", "づ": "zɯ", "で": "de", "ど": "do",
    # n
    "な": "na", "に": "ɲi", "ぬ": "nɯ", "ね": "ne", "の": "no",
    # h/b/p
    "は": "ha", "ひ": "çi", "ふ": "ɸɯ", "へ": "he", "ほ": "ho",
    "ば": "ba", "び": "bi", "ぶ": "bɯ", "べ": "be", "ぼ": "bo",
    "ぱ": "pa", "ぴ": "pi", "ぷ": "pɯ", "ぺ": "pe", "ぽ": "po",
    # m
    "ま": "ma", "み": "mi", "む": "mɯ", "め": "me", "も": "mo",
    # y
    "や": "ja", "ゆ": "jɯ", "よ": "jo",
    # r
    "ら": "ɾa", "り": "ɾi", "る": "ɾɯ", "れ": "ɾe", "ろ": "ɾo",
    # w
    "わ": "wa", "を": "o", "ん": "ɴ",
    # small vowels (rare standalone)
    "ぁ": "a", "ぃ": "i", "ぅ": "ɯ", "ぇ": "e", "ぉ": "o",
    "ゔ": "vɯ",
}

_DIGRAPH_SECOND = {"ゃ": "ja", "ゅ": "jɯ", "ょ": "jo"}

# Consonant-onset extraction for digraphs: きゃ = k + ja → kʲa-style; we
# approximate with onset + j + vowel.
_ONSET = {
    "き": "k", "ぎ": "ɡ", "し": "ɕ", "じ": "dʑ", "ち": "tɕ", "ぢ": "dʑ",
    "に": "ɲ", "ひ": "ç", "び": "b", "ぴ": "p", "み": "m", "り": "ɾ",
}


def _kata_to_hira(ch: str) -> str:
    o = ord(ch)
    if 0x30A1 <= o <= 0x30F6:  # katakana → hiragana
        return chr(o - 0x60)
    return ch


def kana_to_ipa(text: str) -> str:
    """Transliterate kana to IPA; non-kana characters pass through if they are
    punctuation/ascii, else are dropped."""
    out: list[str] = []
    chars = [_kata_to_hira(c) for c in text]
    i = 0
    while i < len(chars):
        c = chars[i]
        nxt = chars[i + 1] if i + 1 < len(chars) else ""
        if c in _ONSET and nxt in _DIGRAPH_SECOND:
            base = _DIGRAPH_SECOND[nxt]
            onset = _ONSET[c]
            # ɕ/tɕ/dʑ/ɲ/ç already palatal: drop the j glide.
            if onset in ("ɕ", "tɕ", "dʑ", "ɲ", "ç"):
                out.append(onset + base[1:])
            else:
                out.append(onset + base)
            i += 2
            continue
        if c == "っ":  # sokuon: geminate the next onset
            if nxt in _BASE and _BASE[nxt]:
                out.append(_BASE[nxt][0])
            i += 1
            continue
        if c == "ー":  # long vowel: repeat previous vowel with length mark
            if out and out[-1] and out[-1][-1] in "aiɯeo":
                out.append("ː")
            i += 1
            continue
        if c in _BASE:
            out.append(_BASE[c])
        elif c.isascii() or c in ";:,.!?¡¿—…\"«»“”() *~-/\\&、。":
            out.append("." if c in "、。" else c)
        # else: kanji/unknown — dropped (needs a reading dictionary)
        i += 1
    return "".join(out)


def has_kana(text: str) -> bool:
    return any(0x3041 <= ord(c) <= 0x30F6 or c == "ー" for c in text)
