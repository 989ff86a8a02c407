"""Fixed against per-frame cost: full generates at several lengths, then the
DAC decode of the longest one's codes (the port's counterpart of
``tools/profile_components.py``).

    python -m zonos_tpu_torch.tools.profile_components [--device cpu]

The seeded bf16 flagship (seed 0, unquantized), conditioning [2, 80, 2048] ×
0.05 from ``default_rng(0)``, cfg 2.0, min-p 0.1, seed 2, EOS forbidden, at
86, 430 and 860 frames: each length run once to warm up, then timed twice
(the DAC three times), every timed span ending after the device has
finished. The lines printed are the JAX tool's, after one naming the card
and its power limit. It runs on the card unless ``--device`` names another
device.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile(cfg, frames=(86, 430, 860), device=None, autoencoder=None) -> dict:
    """Print and return the mean seconds of a ``generate`` at each length in
    ``frames`` and of a DAC decode of the last length's codes. ``autoencoder``
    defaults to the DAC at bf16 on ``device``."""
    from zonos_tpu_torch import resolve_device
    from zonos_tpu_torch.codec.dac import DACAutoencoder
    from zonos_tpu_torch.models.zonos import Zonos
    from zonos_tpu_torch.ops.sampling import SamplingParams
    from zonos_tpu_torch.runtime import generate as G
    from zonos_tpu_torch.utils.sysinfo import nvidia_smi

    device = resolve_device(device)
    card = (nvidia_smi("name,power.limit") or ["not read"])[0] if device.type == "cuda" else "cpu"
    print(f"device: {card}", flush=True)
    model = Zonos.from_config(cfg, seed=0, dtype=torch.bfloat16, device=device)
    ae = autoencoder or DACAutoencoder(dtype=torch.bfloat16, device=device)
    cond = np.random.default_rng(0).normal(size=(2, 80, cfg.backbone.d_model)).astype(np.float32) * 0.05

    def timed(f, n):
        f()  # warm
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(n):
            r = f()
        _sync(device)
        return (time.perf_counter() - t0) / n, r

    out = {"card": card, "generate_s": {}}
    codes = None
    for n_frames in frames:
        def run():
            return G.generate(model.params, cfg, cond, max_new_tokens=n_frames, cfg_scale=2.0,
                              sampling_params=SamplingParams(min_p=0.1), seed=2, dtype=torch.bfloat16,
                              forbid_eos=True, device=device)
        t, codes = timed(run, 2)
        out["generate_s"][n_frames] = t
        print(f"generate {n_frames} frames: {t:.3f}s  ({t / n_frames * 1000:.2f} ms/frame)", flush=True)
    t, _ = timed(lambda: ae.decode(codes), 3)
    out["dac_s"], out["dac_frames"] = t, codes.shape[-1]
    print(f"dac decode {codes.shape[-1]} frames: {t:.3f}s", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", help="torch device (default: the card; raises without one)")
    args = ap.parse_args(argv)
    from zonos_tpu_torch.config import zonos_v01_transformer_config

    with torch.no_grad():
        profile(zonos_v01_transformer_config(), device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
