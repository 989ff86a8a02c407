"""``zonos_tpu_torch.tools.e2e_demo`` and ``tools.profile_components`` on the
CPU, at tiny size.

The demo's tiny model decodes through the tiny DAC of
tests/test_torch_dac_encoder.py, which stands in for the full-size codec
(too slow on the CPU). Its files land in the test's own directory. torch
cannot replay ``jax.random``, so the sampled codes are not compared with
JAX's; the conditioning of each of the recipe's texts is, on a tiny model
bridged from JAX.
"""

import importlib.util
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_dac_encoder import DAC_KW
from zonos_tpu.config import tiny_transformer_config as j_tiny
from zonos_tpu.models.zonos import Zonos as JZonos
from zonos_tpu.serving import pipeline as JP
from zonos_tpu_torch.audio.io import read_wav
from zonos_tpu_torch.bridge import params_from_jax
from zonos_tpu_torch.codec import dac as TDAC
from zonos_tpu_torch.config import DACConfig, tiny_transformer_config
from zonos_tpu_torch.models.zonos import Zonos
from zonos_tpu_torch.serving import app_config
from zonos_tpu_torch.serving import pipeline as TP
from zonos_tpu_torch.tools import e2e_demo, profile_components

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: the tiny models' ops are too small to split, and
    threads that parallel test workers start on shared cores stall each
    other's decode loops (the engine's several issuing threads most)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_dac():
    return TDAC.DACAutoencoder(cfg=DACConfig(**DAC_KW), dtype=torch.float32, frame_bucket=8, device="cpu", seed=3)


@pytest.fixture
def demo_env(tmp_path, monkeypatch):
    """The tiny DAC in place of the full-size one, the test's directory as the
    working directory, and the logging set-up that run() does put back after."""
    dac = _tiny_dac()
    monkeypatch.setattr(TDAC, "DACAutoencoder", lambda *a, **kw: dac)
    monkeypatch.chdir(tmp_path)
    logger = logging.getLogger("zonos_tpu_torch")
    monkeypatch.setattr(app_config, "_LOGGING_DONE", app_config._LOGGING_DONE)
    monkeypatch.setattr(logger, "handlers", list(logger.handlers))
    monkeypatch.setattr(logger, "level", logger.level)
    return tmp_path


def test_demo_writes_three_wavs_and_the_long_runs_are_equal(demo_env, caplog):
    with caplog.at_level(logging.INFO, logger="zonos_tpu_torch"):
        assert e2e_demo.main(["--model", "tiny", "--device", "cpu"]) == 0
    files = {name: demo_env / "output_temp" / f"demo_{name}.wav" for name, _ in e2e_demo.RUNS}
    for path in files.values():
        wav, sr = read_wav(str(path))
        assert sr == 44100 and wav.shape[-1] > 0 and np.isfinite(wav).all()
    assert files["long_cold"].read_bytes() == files["long_warm"].read_bytes()
    assert files["short"].read_bytes() != files["long_cold"].read_bytes()
    for name, _ in e2e_demo.RUNS:
        assert any(m.startswith(f"{name}: ") and " RTF " in m for m in caplog.messages), name
        assert f"{name}: ASR SKIP (no Whisper weights in the local cache)" in caplog.messages


def test_demo_recipe_is_the_jax_tools():
    spec = importlib.util.spec_from_file_location("jax_e2e_demo", os.path.join(REPO, "tools", "e2e_demo.py"))
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    assert (e2e_demo.SHORT_TEXT, e2e_demo.LONG_TEXT, e2e_demo.FIXED_SEED) == (
        jax_tool.SHORT_TEXT, jax_tool.LONG_TEXT, jax_tool.FIXED_SEED)
    assert e2e_demo.RUNS == (("short", e2e_demo.SHORT_TEXT), ("long_cold", e2e_demo.LONG_TEXT),
                             ("long_warm", e2e_demo.LONG_TEXT))


@pytest.mark.parametrize("run", [0, 1])
def test_demo_conditioning_matches_jax(run):
    """Each text's conditioning as ``tts`` builds it (build_cond_dict, then
    prepare_conditioning at cfg 2.0) equals JAX's on a bridged tiny model."""
    jm = JZonos.from_config(j_tiny(), seed=0, dtype=jnp.float32)
    tm = Zonos(tiny_transformer_config(), params_from_jax(jax.tree.map(np.asarray, jm.params)),
               dtype=torch.float32, device="cpu")
    text = e2e_demo.RUNS[run][1]
    ref = jm.prepare_conditioning(JP.build_cond_dict(jm, text=text), cfg_scale=2.0)
    got = tm.prepare_conditioning(TP.build_cond_dict(tm, text=text), cfg_scale=2.0)
    assert got.shape == ref.shape and got.shape[0] == 2
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_demo_profile_writes_a_trace(demo_env, monkeypatch):
    monkeypatch.setattr(e2e_demo, "RUNS", e2e_demo.RUNS[:1])  # one short request: the trace stays small
    assert e2e_demo.main(["--model", "tiny", "--profile", "--device", "cpu"]) == 0
    traces = list((demo_env / "profile_logs").glob("trace_*.json"))
    assert len(traces) == 1
    with open(traces[0], encoding="utf-8") as f:
        assert '"traceEvents"' in f.read(4096)


def test_profile_components_prints_its_lines(capsys):
    with torch.no_grad():
        out = profile_components.profile(tiny_transformer_config(), frames=(8,), device="cpu",
                                         autoencoder=_tiny_dac())
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "device: cpu"
    assert lines[1].startswith("generate 8 frames: ") and lines[1].endswith(" ms/frame)")
    assert lines[2].startswith("dac decode 8 frames: ") and lines[2].endswith("s")
    assert set(out["generate_s"]) == {8} and out["dac_frames"] == 8 and out["card"] == "cpu"


def test_demo_loads_the_published_names_through_the_model_manager(monkeypatch):
    """``--model transformer`` goes through load_model_if_needed on the device
    asked for (here with ZONOS_TINY_MODEL's tiny stand-in), quantized to
    int8 so that decode runs K1-K3 on the card."""
    from zonos_tpu_torch.serving import model_manager

    monkeypatch.setenv("ZONOS_TINY_MODEL", "1")
    monkeypatch.delenv("ZONOS_PLATFORM", raising=False)
    monkeypatch.setattr(model_manager, "_CURRENT_MODEL", None)
    monkeypatch.setattr(model_manager, "_CURRENT_NAME", None)
    model = e2e_demo.load_model("transformer", "cpu")
    assert model_manager.current_model_name() == "Zyphra/Zonos-v0.1-transformer"
    assert model.device.type == "cpu" and model.default_kv_int8
    assert model.params["heads"]["q"].dtype == torch.int8
    assert e2e_demo.load_model("transformer", "cpu") is model
