"""Export the port's native checkpoint to the reference safetensors layout
(the port's counterpart of ``tools/export_checkpoint.py``).

    python -m zonos_tpu_torch.tools.export_checkpoint --checkpoint ckpt_dir --out ref_dir [--device cpu]

``ckpt_dir`` is a directory written by ``utils.checkpoint.save_checkpoint``
(``params.pt`` and ``config.json``; ``training.finetune_lora --merge``
writes one). ``ref_dir`` receives ``model.safetensors`` (the reference's
tensor names and layout, bf16 but for the leaves a model keeps in f32) and
``config.json``, which ``Zonos.from_local`` of either package reads.
Quantized leaves are dequantized first. It runs on the card unless
``--device`` names another device.
"""

from __future__ import annotations

import argparse
import os
import sys


def export(checkpoint: str, out: str, device=None) -> tuple[str, str]:
    """``checkpoint`` (native) → ``out/{model.safetensors, config.json}``; returns their paths."""
    from zonos_tpu_torch import resolve_device
    from zonos_tpu_torch.config import ZonosConfig
    from zonos_tpu_torch.utils.checkpoint import load_checkpoint
    from zonos_tpu_torch.utils.export import save_reference_checkpoint

    device = resolve_device(device)
    cfg_path = os.path.join(checkpoint, "config.json")
    if not os.path.exists(cfg_path):
        raise FileNotFoundError(f"no config.json in {checkpoint}")
    return save_reference_checkpoint(out, load_checkpoint(checkpoint, device=device), ZonosConfig.from_json(cfg_path))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--checkpoint", required=True, help="native checkpoint directory (params.pt + config.json)")
    ap.add_argument("--out", required=True, help="output directory for model.safetensors + config.json")
    ap.add_argument("--device", help="torch device (default: the card; raises without one)")
    args = ap.parse_args(argv)
    try:
        wpath, cpath = export(args.checkpoint, args.out, args.device)
    except FileNotFoundError as e:
        print(e, file=sys.stderr)
        return 1
    print(f"exported {wpath} ({os.path.getsize(wpath) / 1e6:.1f} MB) + {cpath}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
