"""LoRA fine-tune: a directory of (wav, txt) pairs → an adapter, and optionally
the merged checkpoint (the port's counterpart of ``tools/finetune_lora.py``).

    python -m zonos_tpu_torch.training.finetune_lora --data my_voice/ \\
        --weights ckpt/ --rank 8 --steps 500 --out adapter.npz --merge merged/

``--data`` expects ``<name>.wav`` files with sibling ``<name>.txt``
transcripts. With ``--clone-speaker`` each sample's own audio conditions the
speaker embedding. ``--synthetic N`` replaces the dataset with N random-code
samples, for smoke runs without data or weights. ``--weights`` is the port's
native checkpoint (a directory with ``params.pt``) or a reference checkpoint
directory (``config.json`` + ``model.safetensors``); without it the model is
the ``--model`` preset from ``--seed``. ``--merge`` writes the merged weights
as the port's native checkpoint, ``--export-reference`` also in the
reference safetensors layout. It runs on the card unless ``--device`` names
another device.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data", help="directory of <name>.wav + <name>.txt pairs")
    ap.add_argument("--synthetic", type=int, default=0, help="use N random-code samples instead of --data")
    ap.add_argument("--weights", help="native checkpoint (params.pt) or reference checkpoint directory to adapt "
                                      "(default: random init)")
    ap.add_argument("--model", default="tiny", choices=["tiny", "transformer"],
                    help="config preset when initializing without --weights")
    ap.add_argument("--language", default="en-us")
    ap.add_argument("--clone-speaker", action="store_true",
                    help="condition the speaker embedding on each sample's own audio")
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--scale", type=float, default=2.0, help="adapter scale (alpha/rank)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--frames", type=int, default=256, help="code frames per sample (pad/trim)")
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="adapter.npz", help="adapter output (.npz)")
    ap.add_argument("--merge", help="also write the merged weights as a native checkpoint here")
    ap.add_argument("--export-reference",
                    help="also export the merged weights to the reference safetensors layout in this "
                         "directory (requires --merge)")
    ap.add_argument("--device", default="cuda", help="torch device (default: the card; raises without one)")
    return ap.parse_args(argv)


def _float32(tree):
    import torch

    if isinstance(tree, dict):
        return {k: _float32(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_float32(v) for v in tree]
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.float()
    return tree


def load_model(args):
    """The f32 model to adapt: ``--weights`` (native or reference layout) or the preset."""
    import torch

    from zonos_tpu_torch import resolve_device
    from zonos_tpu_torch.config import ZonosConfig, tiny_transformer_config, zonos_v01_transformer_config
    from zonos_tpu_torch.models.zonos import Zonos

    device = resolve_device(None if args.device == "cuda" else args.device)
    preset = tiny_transformer_config() if args.model == "tiny" else zonos_v01_transformer_config()
    if not args.weights:
        return Zonos.from_config(preset, seed=args.seed, dtype=torch.float32, device=device)
    config_json = os.path.join(args.weights, "config.json")
    if os.path.exists(os.path.join(args.weights, "params.pt")):
        from zonos_tpu_torch.utils.checkpoint import load_checkpoint

        cfg = ZonosConfig.from_json(config_json) if os.path.exists(config_json) else preset
        return Zonos(cfg, _float32(load_checkpoint(args.weights, device=device)), torch.float32, device)
    return Zonos.from_local(config_json, os.path.join(args.weights, "model.safetensors"), dtype=torch.float32,
                            device=device)


def load_examples(args, model) -> list:
    from zonos_tpu_torch.training.data import encode_wav_example, synthetic_dataset

    if args.synthetic:
        return synthetic_dataset(args.synthetic, n_q=model.config.codebook_dimension, seed=args.seed)
    from zonos_tpu_torch.audio.io import read_wav

    examples = []
    for wav_path in sorted(glob.glob(os.path.join(args.data, "*.wav"))):
        txt_path = os.path.splitext(wav_path)[0] + ".txt"
        if not os.path.exists(txt_path):
            print(f"skip {wav_path}: no transcript", file=sys.stderr)
            continue
        with open(txt_path, encoding="utf-8") as f:
            text = f.read().strip()
        wav, sr = read_wav(wav_path)
        speaker = None
        if args.clone_speaker:
            from zonos_tpu_torch.speaker.embedding import make_speaker_embedding

            speaker = make_speaker_embedding(wav, sr, device=model.device)
        examples.append(encode_wav_example(model.autoencoder, text, wav, sr, language=args.language,
                                           speaker=speaker))
    return examples


def run(args, model=None, examples=None) -> dict:
    """Train the adapter on ``model`` (default: ``load_model(args)``) over
    ``examples`` (default: ``load_examples(args, model)``); returns the model,
    the base params, the final ``LoraState``, the per-step losses and
    seconds, the targets each step trained on (``train.count_targets``) and
    the positions per step, padding included (batch × (frames + n_q − 1))."""
    import numpy as np

    from zonos_tpu_torch.training.data import PrefetchLoader, build_batch
    from zonos_tpu_torch.training.lora import build_lora_train_step, init_lora, init_lora_state, save_lora_npz
    from zonos_tpu_torch.training.train import count_targets, make_optimizer, named_leaves

    model = load_model(args) if model is None else model
    cfg = model.config
    examples = load_examples(args, model) if examples is None else examples
    if not examples:
        raise FileNotFoundError(f"no (wav, txt) pairs under {args.data}")
    if not args.synthetic:
        print(f"{len(examples)} samples, {sum(e.codes.shape[-1] for e in examples) / 86.0:.1f} s of audio")

    params = {k: model.params[k] for k in ("embeddings", "heads", "backbone")}
    lora = init_lora(params["backbone"], rank=args.rank, seed=args.seed)
    n_adapter = sum(v.numel() for a in lora.values() for v in a.values())
    n_base = sum(t.numel() for _, t in named_leaves(params))
    print(f"adapter: rank {args.rank}, {n_adapter:,} params ({100.0 * n_adapter / n_base:.2f}% of base)")

    optimizer = make_optimizer(lr=args.lr, warmup=min(20, args.steps // 10 + 1))
    state = init_lora_state(lora, optimizer)
    step = build_lora_train_step(cfg, optimizer, params, scale=args.scale)

    rng = np.random.default_rng(args.seed)

    def batch_fn():
        picks = [examples[i] for i in rng.integers(0, len(examples), size=args.batch)]
        return build_batch(model, picks, frames=args.frames)

    n_q = cfg.codebook_dimension
    losses, step_s, targets = [], [], []
    for i, (cond, delayed, mask) in enumerate(PrefetchLoader(batch_fn, num_batches=args.steps)):
        t = time.perf_counter()
        state, loss = step(state, cond, delayed, mask)
        losses.append(float(loss))  # waits for the step
        step_s.append(time.perf_counter() - t)
        targets.append(count_targets(delayed, mask, cfg.head_vocab_size))
        if i % 20 == 0 or i + 1 == args.steps:
            print(f"step {i + 1}/{args.steps}  loss {losses[-1]:.4f}")

    save_lora_npz(args.out, state.lora)
    print(f"adapter → {args.out}")
    return {"model": model, "params": params, "state": state, "losses": losses, "step_s": step_s,
            "targets": targets, "positions_per_step": args.batch * (args.frames + n_q - 1)}


def main(argv=None) -> int:
    args = parse_args(argv)
    if not (args.data or args.synthetic):
        print("one of --data / --synthetic is required", file=sys.stderr)
        return 2
    try:
        out = run(args)
    except FileNotFoundError as e:
        print(e, file=sys.stderr)
        return 2
    if args.merge:
        import torch

        from zonos_tpu_torch.training.lora import merge_lora
        from zonos_tpu_torch.utils.checkpoint import save_checkpoint

        model = out["model"]
        merged = dict(model.params)
        with torch.no_grad():
            merged["backbone"] = merge_lora(merged["backbone"], out["state"].lora, scale=args.scale)
        save_checkpoint(args.merge, merged, config=model.config)
        print(f"merged checkpoint → {args.merge}")
        if args.export_reference:
            from zonos_tpu_torch.utils.export import save_reference_checkpoint

            wpath, cpath = save_reference_checkpoint(args.export_reference, merged, model.config)
            print(f"reference-format export → {wpath} + {cpath}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
