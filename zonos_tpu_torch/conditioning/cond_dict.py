"""make_cond_dict — the user-facing conditioning API.

API-compatible with the reference (the reference's zonos/conditioning.py:545-644):
same parameter names, defaults, emotion normalization, language-id lookup,
and unconditional-key handling. Values are numpy arrays shaped [1, 1, C]
(device placement happens when the prefix conditioner consumes them).
"""

from __future__ import annotations

import functools
from typing import Iterable

import numpy as np

supported_language_codes = [
    'af', 'am', 'an', 'ar', 'as', 'az', 'ba', 'bg', 'bn', 'bpy', 'bs', 'ca', 'cmn',
    'cs', 'cy', 'da', 'de', 'el', 'en-029', 'en-gb', 'en-gb-scotland', 'en-gb-x-gbclan',
    'en-gb-x-gbcwmd', 'en-gb-x-rp', 'en-us', 'eo', 'es', 'es-419', 'et', 'eu', 'fa',
    'fa-latn', 'fi', 'fr-be', 'fr-ch', 'fr-fr', 'ga', 'gd', 'gn', 'grc', 'gu', 'hak',
    'hi', 'hr', 'ht', 'hu', 'hy', 'hyw', 'ia', 'id', 'is', 'it', 'ja', 'jbo', 'ka',
    'kk', 'kl', 'kn', 'ko', 'kok', 'ku', 'ky', 'la', 'lfn', 'lt', 'lv', 'mi', 'mk',
    'ml', 'mr', 'ms', 'mt', 'my', 'nb', 'nci', 'ne', 'nl', 'om', 'or', 'pa', 'pap',
    'pl', 'pt', 'pt-br', 'py', 'quc', 'ro', 'ru', 'ru-lv', 'sd', 'shn', 'si', 'sk',
    'sl', 'sq', 'sr', 'sv', 'sw', 'ta', 'te', 'tn', 'tr', 'tt', 'ur', 'uz', 'vi',
    'vi-vn-x-central', 'vi-vn-x-south', 'yue',
]  # 109 language codes, byte-identical to reference conditioning.py:525-536
#    (the table is checkpoint-bound: ids are row indices)


# Codes the G2P frontend can phonemize but the checkpoint's language-id table
# (above, fixed at training time) doesn't contain. Each maps to the closest
# in-table id so the request is servable instead of asserting; phonemization
# still runs in the REQUESTED language (the espeak entry keeps the original
# code) — only the learned language-id embedding is approximated.
_LANGUAGE_ID_ALIASES = {
    "uk": "ru",  # Ukrainian: East Slavic, closest in-table id (docs/LANGUAGES.md)
    "no": "nb",  # generic Norwegian → Bokmål
}

_ALIAS_WARNED: set[str] = set()


@functools.lru_cache(maxsize=128)
def _get_language_id(language: str) -> int:
    table = {lang: i for i, lang in enumerate(supported_language_codes)}
    lang = language.lower()
    alias = _LANGUAGE_ID_ALIASES.get(lang)
    if alias is not None and lang not in table:
        if lang not in _ALIAS_WARNED:
            _ALIAS_WARNED.add(lang)
            import logging

            logging.getLogger("zonos_tpu_torch").info(
                "language %r has no checkpoint language-id; using the %r id "
                "(phonemization still runs as %r)", lang, alias, lang,
            )
        lang = alias
    lid = table.get(lang, -1)
    assert lid != -1, f"Unsupported language: {language}. Pick from {supported_language_codes}"
    return lid


def make_cond_dict(
    text: str = "It would be nice to have time for testing, indeed.",
    language: str = "en-us",
    speaker: np.ndarray | None = None,
    emotion: list[float] = [0.3077, 0.0256, 0.0256, 0.0256, 0.0256, 0.0256, 0.2564, 0.3077],
    fmax: float = 22050.0,
    pitch_std: float = 20.0,
    speaking_rate: float = 15.0,
    vqscore_8: list[float] = [0.78] * 8,
    ctc_loss: float = 0.0,
    dnsmos_ovrl: float = 4.0,
    speaker_noised: bool = False,
    unconditional_keys: Iterable[str] = frozenset({"vqscore_8", "dnsmos_ovrl"}),
    device=None,  # accepted for API compatibility; placement is deferred
) -> dict:
    """Build the conditioning dictionary (reference conditioning.py:545-644).

    Returns a dict whose tensor-like values are numpy arrays of shape
    [1, 1, C]; the "espeak" entry stays the ([text], [language]) tuple.
    """
    del device
    cond_dict = {
        "espeak": ([text], [language]),
        "speaker": speaker,
        "emotion": emotion,
        "fmax": fmax,
        "pitch_std": pitch_std,
        "speaking_rate": speaking_rate,
        "language_id": _get_language_id(language),
        "vqscore_8": vqscore_8,
        "ctc_loss": ctc_loss,
        "dnsmos_ovrl": dnsmos_ovrl,
        "speaker_noised": int(speaker_noised),
    }

    for k in unconditional_keys:
        cond_dict.pop(k, None)

    for k, v in list(cond_dict.items()):
        if isinstance(v, (float, int, list)):
            v = np.asarray(v, dtype=np.float32)
        if isinstance(v, np.ndarray) or hasattr(v, "__array__"):
            cond_dict[k] = np.asarray(v, dtype=np.float32).reshape(1, 1, -1)
        if k == "emotion":
            cond_dict[k] = cond_dict[k] / cond_dict[k].sum(axis=-1)

    return cond_dict
