"""The port stands alone: it imports nothing of JAX or of the JAX package, and
its entry points run on the card unless the caller asks for the CPU."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

from zonos_tpu_torch.codec.dac import DACAutoencoder
from zonos_tpu_torch.config import tiny_transformer_config
from zonos_tpu_torch.models.zonos import Zonos
from zonos_tpu_torch.runtime import streaming
from zonos_tpu_torch.runtime.generate import generate
from zonos_tpu_torch.serving import audio_prep, pipeline
from zonos_tpu_torch.speaker.embedding import SpeakerEmbeddingLDA, default_speaker_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_and_chip_smoke_import_without_jax():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = sys.modules["flax"] = sys.modules["zonos_tpu"] = None
        import importlib, pkgutil
        import zonos_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(zonos_tpu_torch.__path__, "zonos_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        assert callable(chip_smoke.main)
        print(len(names), "modules")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[0]) >= 15


@pytest.mark.parametrize("entry", ["zonos", "dac", "generate", "facade", "generate_audio", "stream", "speaker",
                                   "default_speaker", "speaker_audio", "dac_encode", "tts"])
def test_entry_points_default_to_cuda(monkeypatch, tmp_path, entry):
    """Every entry point raises without a card unless the caller asks for the
    CPU. The facade's methods (prepare_conditioning, generate, generate_audio,
    stream) all run on the model's device, which its constructor resolves;
    ``pipeline.tts`` runs on its model's device, and the speaker tower there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cond = torch.zeros(2, 4, 64)
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "zonos":
            Zonos.from_config(tiny_transformer_config())
        elif entry == "dac":
            DACAutoencoder()
        elif entry == "generate":
            generate({}, tiny_transformer_config(), cond)
        elif entry == "facade":
            Zonos(tiny_transformer_config(), {})
        elif entry == "generate_audio":
            streaming.generate_audio({}, tiny_transformer_config(), cond, autoencoder=None)
        elif entry == "speaker":
            SpeakerEmbeddingLDA()
        elif entry == "default_speaker":
            default_speaker_model()
        elif entry == "speaker_audio":
            audio_prep.process_speaker_audio(str(tmp_path / "npc.wav"), "m", use_cache=False)
        elif entry == "dac_encode":
            DACAutoencoder().encode([[0.0] * 512])
        elif entry == "tts":
            pipeline.tts(Zonos(tiny_transformer_config(), {}), "hi", speaker_audio=str(tmp_path / "npc.wav"))
        else:
            next(streaming.generate_stream({}, tiny_transformer_config(), cond))


def test_chip_smoke_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
