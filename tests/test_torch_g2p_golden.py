"""The port's text front end against the frozen 109-language G2P snapshot.

tests/data/g2p_golden.json (written by the JAX package's
tools/make_g2p_golden.py) holds the IPA of a fixed sentence set over all 109
reference language codes. The port keeps its own copy of the front end
(``zonos_tpu_torch.conditioning``); here that copy must reproduce every
entry, so any drift of it from the JAX package's fails by language. The
port's ``tools.make_g2p_golden`` rebuilds the corpus and compares it.
"""

import importlib.util
import json
import os

import pytest

from zonos_tpu.conditioning.cond_dict import supported_language_codes as jax_codes
from zonos_tpu_torch.conditioning.cond_dict import supported_language_codes
from zonos_tpu_torch.conditioning.espeak import phonemize
from zonos_tpu_torch.tools import make_g2p_golden as tool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(tool.SNAPSHOT, encoding="utf-8") as f:
    _GOLDEN: dict[str, list[dict]] = json.load(f)


def test_codes_equal_the_snapshot_and_the_jax_package():
    assert tool.SNAPSHOT == os.path.join(REPO, "tests", "data", "g2p_golden.json")
    assert list(supported_language_codes) == list(jax_codes)
    assert set(_GOLDEN) == set(supported_language_codes)
    assert (len(_GOLDEN), sum(len(rows) for rows in _GOLDEN.values())) == (109, 199)


@pytest.mark.parametrize("code", sorted(_GOLDEN))
def test_port_g2p_matches_golden(code):
    rows = _GOLDEN[code]
    texts = [r["text"] for r in rows]
    got = phonemize(texts, [code] * len(texts))
    for r, ipa in zip(rows, got):
        assert ipa == r["ipa"], f"[{code}] the port's G2P drifted for {r['text']!r}\n  golden: {r['ipa']}\n  got: {ipa}"


def test_sentences_equal_the_jax_tools():
    spec = importlib.util.spec_from_file_location("jax_make_g2p_golden",
                                                  os.path.join(REPO, "tools", "make_g2p_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert tool.SENTENCES == {code: texts for code, texts in mod.SENTENCES.items() if code != "mt-extra-skip"}


def test_diff_returns_0_on_the_snapshot(capsys):
    assert tool.main(["--diff"]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == "0 changed entries"


def test_diff_returns_1_on_a_changed_entry(tmp_path, monkeypatch, capsys):
    changed = json.loads(json.dumps(_GOLDEN))
    changed["de"][1]["ipa"] += "x"
    path = tmp_path / "g2p.json"
    path.write_text(json.dumps(changed, ensure_ascii=False), encoding="utf-8")
    monkeypatch.setattr(tool, "SNAPSHOT", str(path))
    assert tool.main(["--diff"]) == 1
    out = capsys.readouterr().out
    assert out.startswith(f"[de] {_GOLDEN['de'][1]['text']}\n") and out.strip().endswith("1 changed entries")


def test_out_writes_the_snapshot_byte_for_byte(tmp_path, capsys):
    out = tmp_path / "sub" / "g2p.json"
    assert tool.main(["--out", str(out)]) == 0
    assert capsys.readouterr().out.strip() == f"wrote 199 entries for 109 codes → {out}"
    with open(tool.SNAPSHOT, "rb") as f:
        assert out.read_bytes() == f.read()


def test_no_grapheme_fallback():
    """Every entry the port builds comes from an engine, not the lowercase
    grapheme fallback (py is an engineered reading with stress marks)."""
    for code, rows in tool.build().items():
        for r in rows:
            assert r["ipa"].strip() and r["ipa"] != r["text"].lower(), (code, r["text"])


def test_one_of_diff_or_out_is_required(capsys):
    assert tool.main([]) == 2
    assert "one of --diff / --out is required" in capsys.readouterr().err
