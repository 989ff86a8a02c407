"""Host-side text normalization and phoneme tokenization.

Reimplements the reference text frontend (the reference's zonos/conditioning.py:139-335)
without third-party dependencies:

* number normalization (currency, decimals, ordinals, years) in pure Python —
  the reference uses the ``inflect`` package; output follows the same
  conventions (andword omitted, years grouped in pairs, "oh" for 0 tens).
* the IPA phoneme symbol table and tokenizer (PAD/UNK/BOS/EOS = 0..3,
  reference conditioning.py:227-253).

Japanese normalization (sudachipy + kanjize in the reference,
conditioning.py:256-260) is gated on those packages being installed; without
them text passes through NFKC normalization only.

All of this runs on the host: phoneme ids are the device boundary.
"""

from __future__ import annotations

import re
import unicodedata

# ---------------------------------------------------------------------------
# Number → words (English)
# ---------------------------------------------------------------------------

_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy", "eighty", "ninety"]
_SCALES = [
    (10 ** 12, "trillion"),
    (10 ** 9, "billion"),
    (10 ** 6, "million"),
    (10 ** 3, "thousand"),
]

_ORDINAL_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _two_digits(n: int) -> str:
    if n < 20:
        return _ONES[n]
    tens, ones = divmod(n, 10)
    return _TENS[tens] + ("-" + _ONES[ones] if ones else "")


def _three_digits(n: int) -> str:
    hundreds, rest = divmod(n, 100)
    parts = []
    if hundreds:
        parts.append(_ONES[hundreds] + " hundred")
    if rest:
        parts.append(_two_digits(rest))
    return " ".join(parts)


def number_to_words(n: int, group2: bool = False, zero: str = "zero") -> str:
    """Spell an integer in English (inflect-style, no 'and').

    Args:
        n: the number.
        group2: spell in 2-digit groups (year style): 1985 → "nineteen eighty-five".
        zero: word for a 0 group leader ("oh" for years: 1907 → "nineteen oh seven").
    """
    if n < 0:
        return "minus " + number_to_words(-n, group2, zero)
    if group2:
        digits = str(n)
        if len(digits) % 2:
            digits = "0" + digits
        groups = [int(digits[i : i + 2]) for i in range(0, len(digits), 2)]
        words = []
        for g in groups:
            if g == 0:
                words.append(zero + " " + zero if zero == "oh" else zero)
            elif g < 10:
                words.append((zero + " " if zero == "oh" else "") + _ONES[g])
            else:
                words.append(_two_digits(g))
        return " ".join(words)
    if n == 0:
        return zero
    parts = []
    for scale, name in _SCALES:
        if n >= scale:
            count, n = divmod(n, scale)
            parts.append(_three_digits(count) + " " + name)
    if n:
        parts.append(_three_digits(n))
    return ", ".join(parts)


def ordinal_to_words(n: int) -> str:
    """Spell an ordinal: 3 → "third", 21 → "twenty-first"."""
    words = number_to_words(n)
    # Replace the final word with its ordinal form.
    for sep in ("-", " "):
        head, _, last = words.rpartition(sep)
        if not head:
            continue
        return head + sep + _ordinalize_word(last)
    return _ordinalize_word(words)


def _ordinalize_word(w: str) -> str:
    if w in _ORDINAL_IRREGULAR:
        return _ORDINAL_IRREGULAR[w]
    if w.endswith("y"):
        return w[:-1] + "ieth"
    if w.endswith("t"):  # eight handled above; e.g. "thousand" doesn't end in t
        return w + "h"
    return w + "th"


# --- Number normalization (regexes + expansion control flow) ---
# Derived from the keithito/tacotron text cleaners (MIT), the same public
# lineage the reference credits for its copy ("functions to convert numbers
# to english text, copied from p0p4k/vits2_pytorch" — reference
# conditioning.py:139-221, itself from keithito/tacotron cleaners.py).
# The word-spelling backend underneath (number_to_words/ordinals above) is
# reimplemented here in pure Python instead of depending on `inflect`.

_comma_number_re = re.compile(r"([0-9][0-9\,]+[0-9])")
_decimal_number_re = re.compile(r"([0-9]+\.[0-9]+)")
_pounds_re = re.compile(r"£([0-9\,]*[0-9]+)")
_dollars_re = re.compile(r"\$([0-9\.\,]*[0-9]+)")
_ordinal_re = re.compile(r"[0-9]+(st|nd|rd|th)")
_number_re = re.compile(r"[0-9]+")


def _expand_dollars(m: re.Match) -> str:
    match = m.group(1)
    parts = match.split(".")
    if len(parts) > 2:
        return match + " dollars"
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        d_unit = "dollar" if dollars == 1 else "dollars"
        c_unit = "cent" if cents == 1 else "cents"
        return f"{dollars} {d_unit}, {cents} {c_unit}"
    if dollars:
        return f"{dollars} {'dollar' if dollars == 1 else 'dollars'}"
    if cents:
        return f"{cents} {'cent' if cents == 1 else 'cents'}"
    return "zero dollars"


def _expand_number(m: re.Match) -> str:
    num = int(m.group(0))
    if 1000 < num < 3000:
        if num == 2000:
            return "two thousand"
        if 2000 < num < 2010:
            return "two thousand " + number_to_words(num % 100)
        if num % 100 == 0:
            return number_to_words(num // 100) + " hundred"
        return number_to_words(num, group2=True, zero="oh").replace(", ", " ")
    return number_to_words(num)


def normalize_numbers(text: str) -> str:
    """Expand numeric expressions to words (reference conditioning.py:199-221)."""
    text = _comma_number_re.sub(lambda m: m.group(1).replace(",", ""), text)
    text = _pounds_re.sub(r"\1 pounds", text)
    text = _dollars_re.sub(_expand_dollars, text)
    text = _decimal_number_re.sub(lambda m: m.group(1).replace(".", " point "), text)
    text = _ordinal_re.sub(lambda m: ordinal_to_words(int(m.group(0)[:-2])), text)
    text = _number_re.sub(_expand_number, text)
    return text


# ---------------------------------------------------------------------------
# Japanese normalization (optional deps)
# ---------------------------------------------------------------------------

try:  # pragma: no cover - optional host packages
    from kanjize import number2kanji  # type: ignore
    from sudachipy import Dictionary, SplitMode  # type: ignore

    _JP_TOKENIZER = Dictionary(dict="full").create()

    def normalize_jp_text(text: str) -> str:
        text = unicodedata.normalize("NFKC", text)
        text = re.sub(r"\d+", lambda m: number2kanji(int(m[0])), text)
        return " ".join(x.reading_form() for x in _JP_TOKENIZER.tokenize(text, SplitMode.A))

    HAS_JAPANESE = True
except Exception:
    HAS_JAPANESE = False

    def normalize_jp_text(text: str) -> str:
        """Embedded fallback: numerals + common kanji → kana (see ja.py).

        Below a real morphological analyzer but far above dropping kanji;
        the downstream kana→IPA mapper (kana.py) then reads the result.
        """
        from zonos_tpu_torch.conditioning.ja import read_japanese

        text = unicodedata.normalize("NFKC", text)
        return read_japanese(text)


def clean(texts: list[str], languages: list[str]) -> list[str]:
    """Language-aware cleanup before phonemization (conditioning.py:263-288).

    Deviations from the reference (both quality-positive):
    * digits in Chinese-family requests (cmn/yue/hak/zh) are NOT rewritten
      to English number-words — both eSpeak's zh voices and the native
      readers (conditioning/{zh,yue}.py) read digits natively, which the
      reference's English normalization would have destroyed;
    * for ~20 other languages, digits become NATIVE number-words
      (conditioning/numwords.py: vingt-cinq, fünfundzwanzig, двадцать
      пять, …) instead of the reference's English words-in-a-foreign-
      accent. Unsupported languages keep the reference's English path."""
    from zonos_tpu_torch.conditioning import numwords

    out = []
    for text, language in zip(texts, languages):
        if "ja" in language:
            out.append(normalize_jp_text(text))
        elif language[:3] in ("cmn", "yue", "hak") or language[:2] == "zh":
            out.append(text)
        elif not language.startswith("en"):
            # Currency symbols first (reference behavior, text.py regexes):
            # "$5.50" → "5.50 dollars" so the unit is spoken; the amount
            # itself then localizes below.
            pre = _pounds_re.sub(r"\1 pounds", text)
            pre = _dollars_re.sub(_expand_dollars, pre)
            localized = numwords.localize_numbers(pre, language)
            out.append(localized if localized is not None else normalize_numbers(text))
        else:
            out.append(normalize_numbers(text))
    return out


# ---------------------------------------------------------------------------
# Phoneme symbol table & tokenizer (conditioning.py:227-253)
# ---------------------------------------------------------------------------

PAD_ID, UNK_ID, BOS_ID, EOS_ID = 0, 1, 2, 3
SPECIAL_TOKEN_IDS = [PAD_ID, UNK_ID, BOS_ID, EOS_ID]

_punctuation = ';:,.!?¡¿—…"«»“”() *~-/\\&'
_letters = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
_letters_ipa = (
    "ɑɐɒæɓʙβɔɕçɗɖðʤəɘɚɛɜɝɞɟʄɡɠɢʛɦɧħɥʜɨɪʝɭɬɫɮʟɱɯɰŋɳɲɴøɵɸθœɶʘɹɺɾɻʀʁɽʂʃʈʧʉʊʋⱱʌɣɤʍχʎʏʑʐʒʔʡʕʢǀǁǂǃˈˌːˑʼʴʰʱʲʷˠˤ˞↓↑→↗↘'̩'ᵻ"
)

symbols = [*_punctuation, *_letters, *_letters_ipa]
_symbol_to_id = {s: i for i, s in enumerate(symbols, start=len(SPECIAL_TOKEN_IDS))}

PHONEME_VOCAB_SIZE = len(SPECIAL_TOKEN_IDS) + len(symbols)


def get_symbol_ids(text: str) -> list[int]:
    return [_symbol_to_id.get(s, UNK_ID) for s in text]


# Serving sets this to a bucket (e.g. 32) so the phoneme sequence length —
# and with it every conditioner/prefill shape — is drawn from a small set:
# an eager/jit compile is keyed on shapes, and over a remote-TPU link each
# novel text length otherwise costs seconds of XLA compiles (measured 13-19 s
# admission stalls in the continuous engine under mixed-text load). Padding
# with attended PAD_ID embeddings is exactly what the reference does to every
# batched text (conditioning.py:248-253); the library default (1) keeps
# single-request output byte-identical to the reference's unpadded call.
PAD_BUCKET = 1


def tokenize_phonemes(phonemes: list[str]) -> tuple[list[list[int]], list[int]]:
    """BOS + ids + EOS per string, left-padded with PAD to the batch max
    (rounded up to PAD_BUCKET).

    Returns (padded id lists, true lengths). Reference conditioning.py:248-253.
    """
    ids = [[BOS_ID, *get_symbol_ids(p), EOS_ID] for p in phonemes]
    lengths = [len(x) for x in ids]
    bucket = max(int(PAD_BUCKET), 1)
    longest = -(-max(lengths) // bucket) * bucket
    padded = [[PAD_ID] * (longest - len(x)) + x for x in ids]
    return padded, lengths
