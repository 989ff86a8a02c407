"""``zonos_tpu_torch.tools.validate_checkpoint`` on the CPU, mirroring
tests/test_validate_checkpoint.py on the same random-init fake checkpoint
(the only kind this repository can produce), with a random-init
transformers DacModel written under the test's own directory for the DAC
check."""

import importlib.util
import os
import sys

import pytest
import torch

from tests.test_checkpoint import make_fake_checkpoint
from zonos_tpu_torch.tools import validate_checkpoint as tool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location("jax_validate_checkpoint",
                                                  os.path.join(REPO, "tools", "validate_checkpoint.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclass resolves its module by name
    try:
        spec.loader.exec_module(mod)
        yield mod
    finally:
        del sys.modules[spec.name]


def test_load_check_passes(tmp_path):
    config_path, weights_path, _cfg = make_fake_checkpoint(tmp_path)
    result, model = tool.check_load(config_path, weights_path, dtype=torch.float32, device="cpu")
    assert result.status == "PASS", result
    assert result.metric.endswith("codes (1, 9, 10)")
    assert model is not None and model.device.type == "cpu"


def test_truncated_weights_fail_load_and_exit_1(tmp_path, capsys):
    config_path, weights_path, _cfg = make_fake_checkpoint(tmp_path)
    with open(weights_path, "rb") as f:
        data = f.read()
    with open(weights_path, "wb") as f:
        f.write(data[: len(data) // 2])
    result, model = tool.check_load(config_path, weights_path, device="cpu")
    assert result.status == "FAIL" and model is None, result
    assert tool.main(["--config", config_path, "--weights", weights_path, "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "load      FAIL" in out and out.strip().endswith("RESULT: FAIL")


def test_missing_inputs_skip(tmp_path, monkeypatch):
    assert tool.check_dac(None).status == "SKIP"
    assert tool.check_dac(str(tmp_path / "absent"), device="cpu").status == "SKIP"
    assert tool.check_speaker(None, None).status == "SKIP"
    assert tool.check_speaker(str(tmp_path / "spk.pt"), None).status == "SKIP"
    monkeypatch.setitem(sys.modules, "zonos", None)  # no reference package importable
    config_path, weights_path, _cfg = make_fake_checkpoint(tmp_path)
    r = tool.check_backbone_parity(config_path, weights_path, device="cpu")
    assert r.status == "SKIP" and "reference torch backbone unavailable" in r.detail
    r = tool.check_speaker(str(tmp_path / "spk.pt"), str(tmp_path / "lda.pt"), device="cpu")
    assert r.status == "SKIP" and "reference speaker tower unavailable" in r.detail


@pytest.fixture(scope="module")
def hf_dac_dir(tmp_path_factory):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    d = tmp_path_factory.mktemp("dac")
    transformers.DacModel(transformers.DacConfig()).save_pretrained(str(d))
    return str(d)


def test_dac_check_passes_against_a_random_dac_model(hf_dac_dir):
    r = tool.check_dac(hf_dac_dir, device="cpu")
    assert r.status == "PASS", r
    assert float(r.metric.split("=")[1]) < tool.MAX_DAC_RMSE


def test_an_error_inside_a_check_is_its_fail_row(tmp_path):
    """A DAC directory that is there but unreadable FAILs; it is not SKIPped."""
    pytest.importorskip("transformers")
    (tmp_path / "dac").mkdir()
    r = tool.check_dac(str(tmp_path / "dac"), device="cpu")
    assert r.status == "FAIL" and r.detail, r


def test_table_equals_the_jax_tools(jax_tool, capsys):
    rows = [("load", "PASS", "ok", ""), ("dac", "SKIP", "", "not given"), ("backbone", "FAIL", "bad", "x")]
    for n in (2, 3):
        assert tool.print_table([tool.CheckResult(*r) for r in rows[:n]]) is (n == 2)
        ours = capsys.readouterr().out
        assert jax_tool.print_table([jax_tool.CheckResult(*r) for r in rows[:n]]) is (n == 2)
        assert ours == capsys.readouterr().out
        assert ours.strip().endswith("RESULT: PASS" if n == 2 else "RESULT: FAIL")


def test_backbone_parity_check_passes(tmp_path):
    pytest.importorskip("zonos.backbone._torch")
    config_path, weights_path, _cfg = make_fake_checkpoint(tmp_path)
    result = tool.check_backbone_parity(config_path, weights_path, steps=8, device="cpu")
    assert result.status == "PASS", (result.metric, result.detail)
    assert "8/8" in result.metric
