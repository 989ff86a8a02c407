"""The fixed-seed demo: the reference's recipe through ``pipeline.tts`` (the
port's counterpart of ``tools/e2e_demo.py``).

    python -m zonos_tpu_torch.tools.e2e_demo [--model tiny|transformer|hybrid] [--profile] [--device cpu]

``tiny`` is the tiny transformer at f32 from seed 0. ``transformer`` and
``hybrid`` load through ``serving.model_manager.load_model_if_needed``: a
local checkpoint, else the local hub cache, else the seeded preset (with a
warning); quantized to int8, so every decode step runs K1-K3. The recipe
(reference test_zonos.py:543-571): seed 4200, a short text, then a long one
twice (``long_cold``, ``long_warm``; with the seed fixed the two are equal),
each written to ``output_temp/demo_<name>.wav`` under the working directory
with its audio seconds, wall seconds and RTF logged. Each is transcribed when
Whisper is in the local cache (``testing.asr_check``); otherwise the check
logs a SKIP. ``--profile`` wraps the runs in
``utils.profiling.torch_trace("profile_logs")``. It runs on the card unless
``--device`` names another device.
"""

from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch

SHORT_TEXT = "Hello there, traveler."
LONG_TEXT = (
    "It would be nice to have time for testing, indeed. The quick brown fox "
    "jumps over the lazy dog while the dragon circles high above the village."
)
FIXED_SEED = 4200  # the reference test's recipe (test_zonos.py:526)
RUNS = (("short", SHORT_TEXT), ("long_cold", LONG_TEXT), ("long_warm", LONG_TEXT))


def load_model(name: str, device=None):
    """The demo's model: ``tiny`` (f32, seed 0) or a published backbone's name
    through the model manager (int8)."""
    if name == "tiny":
        from zonos_tpu_torch.config import tiny_transformer_config
        from zonos_tpu_torch.models.zonos import Zonos

        return Zonos.from_config(tiny_transformer_config(), dtype=torch.float32, device=device)
    from zonos_tpu_torch.serving.model_manager import load_model_if_needed

    return load_model_if_needed(f"Zyphra/Zonos-v0.1-{name}", {}, device=device)


def run(model, profile: bool = False) -> list[dict]:
    """The recipe on ``model``: one dict per run with its name, wav path,
    waveform (int16 PCM), sample rate, audio s, wall s, RTF and
    ``generate_audio``'s stats."""
    from zonos_tpu_torch.serving.app_config import setup_logging
    from zonos_tpu_torch.serving.pipeline import tts
    from zonos_tpu_torch.testing.asr_check import transcribe, word_overlap
    from zonos_tpu_torch.utils.profiling import torch_trace

    logger = setup_logging({})
    results = []
    with torch_trace("profile_logs") if profile else contextlib.nullcontext():
        for name, text in RUNS:
            stats: dict = {}
            t0 = time.perf_counter()
            path, wav, sr, rtf = tts(model, text, randomize_seed=False, seed=FIXED_SEED,
                                     output_path=f"output_temp/demo_{name}.wav", stats=stats)
            wall = time.perf_counter() - t0
            audio_s = wav.shape[-1] / sr
            logger.info(f"{name}: {audio_s:.2f}s audio, {wall:.2f}s wall, RTF {rtf:.2f}x → {path}")
            pcm = wav.astype(np.float32) / 32767.0 if wav.dtype == np.int16 else wav
            heard = transcribe(pcm, sr, device=model.device)
            if heard is None:
                logger.info(f"{name}: ASR SKIP (no Whisper weights in the local cache)")
            else:
                logger.info(f"{name}: ASR '{heard.text}' (word overlap {word_overlap(text, heard.text):.0%})")
            results.append({"name": name, "path": path, "wav": wav, "sr": sr, "audio_s": audio_s, "wall_s": wall,
                            "rtf": rtf, "stats": stats})
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="tiny", choices=["tiny", "transformer", "hybrid"])
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--device", help="torch device (default: the card; raises without one)")
    args = ap.parse_args(argv)
    from zonos_tpu_torch import resolve_device

    run(load_model(args.model, resolve_device(args.device)), profile=args.profile)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
