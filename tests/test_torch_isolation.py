"""The port stands alone: it imports nothing of JAX or of the JAX package, and
its entry points run on the card unless the caller asks for the CPU."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

from zonos_tpu_torch.codec.dac import DACAutoencoder
from zonos_tpu_torch.config import tiny_hybrid_config, tiny_transformer_config
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
                                   "default_speaker", "speaker_audio", "dac_encode", "tts", "hybrid", "from_local",
                                   "from_pretrained"])
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
        elif entry == "hybrid":
            Zonos.from_config(tiny_hybrid_config())
        elif entry == "from_local":
            Zonos.from_local(str(tmp_path / "config.json"), str(tmp_path / "model.safetensors"))
        elif entry == "from_pretrained":
            Zonos.from_pretrained("Zyphra/Zonos-v0.1-hybrid", cache_dir=str(tmp_path))
        else:
            next(streaming.generate_stream({}, tiny_transformer_config(), cond))


def test_checkpoints_need_no_checkpoint_packages(tmp_path):
    """With jax, the JAX package, safetensors, transformers and huggingface_hub
    all blocked, every port module imports, and a tiny hybrid goes through
    save_reference_checkpoint, from_local and the native checkpoint and
    back, and a DAC loads from a hub-cache tree, on the CPU."""
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "flax", "zonos_tpu", "safetensors", "transformers", "huggingface_hub"):
            sys.modules[name] = None
        import importlib, os, pkgutil
        import torch
        import zonos_tpu_torch
        for m in pkgutil.walk_packages(zonos_tpu_torch.__path__, "zonos_tpu_torch."):
            importlib.import_module(m.name)
        from zonos_tpu_torch.codec import dac
        from zonos_tpu_torch.config import DACConfig, tiny_hybrid_config
        from zonos_tpu_torch.models.zonos import Zonos
        from zonos_tpu_torch.utils import checkpoint, export, safetensors_io
        m = Zonos.from_config(tiny_hybrid_config(), seed=0, dtype=torch.bfloat16, device="cpu")
        w, c = export.save_reference_checkpoint({str(tmp_path)!r}, m.params, m.config)
        back = Zonos.from_local(c, w, dtype=torch.bfloat16, device="cpu")
        m = m.quantize()
        assert back.config == m.config and torch.equal(back.params["embeddings"][:, :1026],
                                                      m.params["embeddings"][:, :1026])
        checkpoint.save_checkpoint({str(tmp_path / "native")!r}, m.params, m.config)
        assert torch.equal(checkpoint.load_checkpoint({str(tmp_path / "native")!r})["heads"]["q"],
                           m.params["heads"]["q"])
        cfg = DACConfig(encoder_hidden_size=8, downsampling_ratios=(2, 4), decoder_hidden_size=32,
                        upsampling_ratios=(4, 2), codebook_dim=4, hidden_size=24)
        ae = dac.DACAutoencoder(cfg=cfg, dtype=torch.float32, device="cpu", seed=1)
        sd = {{}}
        def conv(prefix, w, b):
            sd[prefix + ".weight"], sd[prefix + ".bias"] = w, b
        # the seeded codec written in transformers' layout, then read back from a hub tree
        p, q = ae.params, ae.params["quantizer"]
        conv("decoder.conv1", p["decoder"]["conv1"]["w"], p["decoder"]["conv1"]["b"])
        conv("decoder.conv2", p["decoder"]["conv2"]["w"], p["decoder"]["conv2"]["b"])
        sd["decoder.snake1.alpha"] = p["decoder"]["snake_out"][None, :, None]
        for i, blk in enumerate(p["decoder"]["blocks"]):
            sd[f"decoder.block.{{i}}.snake1.alpha"] = blk["snake1"][None, :, None]
            conv(f"decoder.block.{{i}}.conv_t1", blk["conv_t"]["w"], blk["conv_t"]["b"])
            for r, res in enumerate(blk["res"]):
                base = f"decoder.block.{{i}}.res_unit{{r + 1}}"
                sd[base + ".snake1.alpha"] = res["snake1"][None, :, None]
                sd[base + ".snake2.alpha"] = res["snake2"][None, :, None]
                conv(base + ".conv1", res["conv1"]["w"], res["conv1"]["b"])
                conv(base + ".conv2", res["conv2"]["w"], res["conv2"]["b"])
        e = p["encoder"]
        conv("encoder.conv1", e["conv1"]["w"], e["conv1"]["b"])
        conv("encoder.conv2", e["conv2"]["w"], e["conv2"]["b"])
        sd["encoder.snake1.alpha"] = e["snake_out"][None, :, None]
        for i, blk in enumerate(e["blocks"]):
            sd[f"encoder.block.{{i}}.snake1.alpha"] = blk["snake1"][None, :, None]
            conv(f"encoder.block.{{i}}.conv1", blk["conv"]["w"], blk["conv"]["b"])
            for r, res in enumerate(blk["res"]):
                base = f"encoder.block.{{i}}.res_unit{{r + 1}}"
                sd[base + ".snake1.alpha"] = res["snake1"][None, :, None]
                sd[base + ".snake2.alpha"] = res["snake2"][None, :, None]
                conv(base + ".conv1", res["conv1"]["w"], res["conv1"]["b"])
                conv(base + ".conv2", res["conv2"]["w"], res["conv2"]["b"])
        for i in range(cfg.n_codebooks):
            base = f"quantizer.quantizers.{{i}}"
            sd[base + ".codebook.weight"] = q["codebooks"][i]
            conv(base + ".in_proj", q["in_proj_w"][i].T[:, :, None], q["in_proj_b"][i])
            conv(base + ".out_proj", q["out_proj_w"][i].T[:, :, None], q["out_proj_b"][i])
        snap = {str(tmp_path / "hub" / "models--descript--dac_44khz" / "snapshots" / "0")!r}
        os.makedirs(snap)
        safetensors_io.save_file({{k: v.contiguous() for k, v in sd.items()}}, snap + "/model.safetensors")
        os.environ["HF_HUB_CACHE"] = {str(tmp_path / "hub")!r}
        loaded = dac.DACAutoencoder(cfg=cfg, dtype=torch.float32, device="cpu")
        codes = torch.randint(0, 1024, (1, 9, 8))
        assert torch.equal(loaded.decode_device(codes), ae.decode_device(codes))
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_chip_smoke_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
