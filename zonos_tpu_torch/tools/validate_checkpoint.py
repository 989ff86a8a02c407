"""Validate a reference-layout checkpoint on the port: the checks to run when
real weights arrive (the port's counterpart of ``tools/validate_checkpoint.py``).

    python -m zonos_tpu_torch.tools.validate_checkpoint \\
        --config /path/to/config.json --weights /path/to/model.safetensors \\
        [--dac /path/to/descript-audio-codec-44khz]   # a transformers DacModel directory
        [--speaker ResNet293_SimAM_ASP_base.pt --lda ResNet293_SimAM_ASP_base_LDA-128.pt]
        [--device cpu]

Checks, one row each of the table it prints:

  load        config.json + model.safetensors through Zonos.from_local on the
              device, prepare_conditioning and a 10-token generate
  backbone    hidden states and greedy tokens against the reference torch
              backbone (zonos.backbone._torch, importable from
              ZONOS_REFERENCE_PATH) fed the same weights, on the CPU. The
              reference applies out_proj twice (_torch.py:419-420); the
              comparison patches it to a single application.
  dac         waveform RMSE against transformers.DacModel on the same codes
  speaker     embedding cosine against the reference speaker tower

A check SKIPs only when its input or a dependency is absent; an error inside
a check is its FAIL row. The exit status is 1 when any row FAILs. The
thresholds are the JAX package's:

  backbone hidden max|Δ|   < 5e-2 (bf16 weights, f32 compute)
  backbone greedy tokens   100% match over 32 decode steps
  dac waveform RMSE        < 1e-4 (f32)
  speaker cosine           > 0.999

It runs on the card unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import sys

import numpy as np
import torch

MAX_HIDDEN_DELTA = 5e-2
MAX_DAC_RMSE = 1e-4
MIN_SPEAKER_COSINE = 0.999


@dataclasses.dataclass
class CheckResult:
    name: str
    status: str  # PASS | FAIL | SKIP
    metric: str = ""
    detail: str = ""


def _fail_row(name: str):
    """An exception raised inside the check becomes its FAIL row."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            try:
                return fn(*args, **kwargs)
            except Exception as e:  # noqa: BLE001 - reported as the row, the table goes on
                return CheckResult(name, "FAIL", detail=f"{type(e).__name__}: {e}")
        return run
    return wrap


def _reference_on_path() -> None:
    ref = os.environ.get("ZONOS_REFERENCE_PATH")
    if ref and os.path.isdir(ref) and ref not in sys.path:
        sys.path.insert(0, ref)


def _f32_convolutions():
    """cuDNN's f32 convolutions without TF32 (its default on the card), as the CPU reference computes them."""
    return torch.backends.cudnn.flags(enabled=True, allow_tf32=False)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def check_load(config_path: str, weights_path: str, dtype=torch.bfloat16, device=None):
    """Load + forward smoke test on ``device``. Returns (result, model or None)."""
    from zonos_tpu_torch.conditioning.cond_dict import make_cond_dict
    from zonos_tpu_torch.models.zonos import Zonos

    try:
        model = Zonos.from_local(config_path, weights_path, dtype=dtype, device=device)
    except Exception as e:  # noqa: BLE001
        return CheckResult("load", "FAIL", detail=f"{type(e).__name__}: {e}"), None
    try:
        cd = make_cond_dict(text="validation", speaker=np.zeros((1, 1, 128), np.float32))
        known = set(model.conditioner_names)
        cond = model.prepare_conditioning({k: v for k, v in cd.items() if k in known})
        codes = model.generate(cond, max_new_tokens=10, seed=0)
        n = sum(x.numel() for x in _leaves(model.params))
        return CheckResult("load", "PASS", metric=f"{n / 1e6:.1f}M params, codes {tuple(codes.shape)}"), model
    except Exception as e:  # noqa: BLE001
        return CheckResult("load", "FAIL", detail=f"forward: {type(e).__name__}: {e}"), None


def _patch_single_out_proj(ref_torch) -> None:
    """Make the reference's Attention apply out_proj once per forward, so the
    comparison measures the weights' semantics and not the fork's bug."""
    if hasattr(ref_torch.Attention, "_orig_forward"):
        return
    ref_torch.Attention._orig_forward = ref_torch.Attention.forward

    def once(self, *a, **kw):
        proj = self.out_proj
        calls = {"n": 0}

        class _Once(torch.nn.Module):
            def forward(_s, y):
                calls["n"] += 1
                return proj(y) if calls["n"] == 1 else y

        self.out_proj = _Once()
        try:
            return ref_torch.Attention._orig_forward(self, *a, **kw)
        finally:
            self.out_proj = proj

    ref_torch.Attention.forward = once


@_fail_row("backbone")
def check_backbone_parity(config_path: str, weights_path: str, steps: int = 32, device=None):
    """Hidden-state + greedy-token parity against the reference torch backbone."""
    _reference_on_path()
    try:
        from zonos.backbone import _torch as ref_torch
        from zonos.config import BackboneConfig as RefBackboneConfig
        from zonos.config import InferenceParams
    except ImportError as e:
        return CheckResult("backbone", "SKIP", detail=f"reference torch backbone unavailable: {e}")

    from zonos_tpu_torch import resolve_device
    from zonos_tpu_torch.config import ZonosConfig
    from zonos_tpu_torch.models.transformer import KVCache, transformer_forward
    from zonos_tpu_torch.utils.loading import load_safetensors, torch_state_dict_to_params

    with open(config_path) as f:
        raw = json.load(f)
    if raw.get("backbone", {}).get("ssm_cfg"):
        return CheckResult("backbone", "SKIP",
                           detail="hybrid checkpoint: the reference backbone needs mamba-ssm")
    device = resolve_device(device)
    cfg = ZonosConfig.from_dict(raw)
    b = cfg.backbone
    sd = load_safetensors(weights_path)
    ours = torch_state_dict_to_params(sd, cfg, torch.float32, device)

    ref_cfg = RefBackboneConfig(
        d_model=b.d_model, attn_mlp_d_intermediate=b.attn_mlp_d_intermediate, n_layer=b.n_layer,
        attn_layer_idx=list(b.attn_layer_idx),
        attn_cfg={"num_heads": b.attn_cfg.num_heads, "num_heads_kv": b.attn_cfg.num_heads_kv},
    )
    bb = ref_torch.TorchZonosBackbone(ref_cfg).float().eval()
    missing, _unexpected = bb.load_state_dict(
        {k[len("backbone."):]: v.float() for k, v in sd.items() if k.startswith("backbone.")}, strict=False)
    if missing:
        return CheckResult("backbone", "FAIL", detail=f"reference missing keys: {missing[:4]}…")
    _patch_single_out_proj(ref_torch)

    # A fixed prompt of embeddings, then greedy tokens from the fused heads.
    rng = np.random.default_rng(0)
    s0, bsz, d = 16, 1, b.d_model
    x0 = (rng.standard_normal((bsz, s0, d)) * 0.02).astype(np.float32)
    kv = bb.allocate_inference_cache(bsz, 256, dtype=torch.float32)
    inf = InferenceParams(256, bsz, 0, 0, kv, lengths_per_sample=torch.zeros(bsz, dtype=torch.int32))
    inf.seqlen_offset = 0
    pad = torch.zeros((bsz,), dtype=torch.int32, device=device)
    cache = KVCache.create(b, bsz, 256, torch.float32, device=device)
    with torch.no_grad():
        h_ref = bb(torch.from_numpy(x0), inf)
        h_ours, cache = transformer_forward(ours["backbone"], b, torch.from_numpy(x0).to(device), cache,
                                            write_start=0, pad_amount=pad, attend_len=s0)
        max_delta = float((h_ours.cpu() - h_ref).abs().max())
        heads = ours["heads"].float().cpu()  # [D, 9 * 1025]
        n_q = cfg.codebook_dimension
        tok_match = 0
        x_step = x0[:, -1:, :]
        for t in range(steps):
            inf.lengths_per_sample[:] = s0 + t
            inf.seqlen_offset = s0 + t
            hr = bb(torch.from_numpy(x_step), inf)
            ho, cache = transformer_forward(ours["backbone"], b, torch.from_numpy(x_step).to(device), cache,
                                            write_start=s0 + t, pad_amount=pad, attend_len=s0 + t + 1)
            ho = ho.cpu()
            max_delta = max(max_delta, float((ho - hr).abs().max()))
            lo, lr = ho[0, -1] @ heads, hr[0, -1] @ heads
            tok_match += int(torch.equal(lo.reshape(n_q, -1).argmax(-1), lr.reshape(n_q, -1).argmax(-1)))
            x_step = (rng.standard_normal((bsz, 1, d)) * 0.02).astype(np.float32)

    ok = max_delta < MAX_HIDDEN_DELTA and tok_match == steps
    return CheckResult("backbone", "PASS" if ok else "FAIL",
                       metric=f"max|Δh|={max_delta:.2e}, greedy tokens {tok_match}/{steps}",
                       detail=f"thresholds: max|Δh| < {MAX_HIDDEN_DELTA:g}, tokens {steps}/{steps}")


@_fail_row("dac")
def check_dac(dac_path: str | None, device=None):
    """Waveform RMSE against transformers.DacModel on identical codes."""
    if not dac_path:
        return CheckResult("dac", "SKIP", detail="--dac not given")
    if not os.path.isdir(dac_path):
        return CheckResult("dac", "SKIP", detail=f"no directory {dac_path}")
    try:
        from transformers import DacModel
    except ImportError as e:
        return CheckResult("dac", "SKIP", detail=f"transformers unavailable: {e}")

    from zonos_tpu_torch import resolve_device
    from zonos_tpu_torch.codec.dac import DACAutoencoder, convert_hf_dac_state_dict
    from zonos_tpu_torch.config import DACConfig

    device = resolve_device(device)
    hf = DacModel.from_pretrained(dac_path).float().eval()
    cfg = DACConfig()  # the 44 kHz reference codec layout
    params = convert_hf_dac_state_dict(hf.state_dict(), cfg, device=device)
    rng = np.random.default_rng(1)
    codes = rng.integers(0, cfg.codebook_size, size=(1, cfg.n_codebooks, 40)).astype(np.int32)
    # one bucket of exactly the codes' frames: no padded frames reach the right edge
    ours = DACAutoencoder(params=params, cfg=cfg, dtype=torch.float32, frame_bucket=codes.shape[-1], device=device)
    with torch.no_grad():
        ref = hf.decode(audio_codes=torch.from_numpy(codes).long()).audio_values.numpy()
    with _f32_convolutions():
        wav = ours.decode(codes)[:, 0]
    n = min(ref.shape[-1], wav.shape[-1])
    rmse = float(np.sqrt(np.mean((ref[..., :n] - wav[..., :n]) ** 2)))
    return CheckResult("dac", "PASS" if rmse < MAX_DAC_RMSE else "FAIL", metric=f"RMSE={rmse:.2e}",
                       detail=f"threshold < {MAX_DAC_RMSE:g}")


@_fail_row("speaker")
def check_speaker(speaker_path: str | None, lda_path: str | None, device=None):
    """Embedding cosine against the reference speaker tower (which loads its own weights)."""
    if not speaker_path or not lda_path:
        return CheckResult("speaker", "SKIP", detail="--speaker and --lda not given")
    _reference_on_path()
    try:
        import zonos.speaker_cloning as ref_mod
    except ImportError as e:
        return CheckResult("speaker", "SKIP", detail=f"reference speaker tower unavailable (needs torchaudio): {e}")
    try:
        ref = ref_mod.SpeakerEmbeddingLDA(device="cpu")
    except OSError as e:
        return CheckResult("speaker", "SKIP", detail=f"reference weights unavailable: {e}")

    from zonos_tpu_torch.speaker.embedding import SpeakerEmbeddingLDA

    ours = SpeakerEmbeddingLDA(ckpt_path=speaker_path, lda_ckpt_path=lda_path, device=device)
    wav = np.random.default_rng(2).standard_normal(16000 * 2).astype(np.float32) * 0.1
    with torch.no_grad():
        ref_emb = ref(torch.from_numpy(wav)[None], 16000)[1].numpy().ravel()
    with _f32_convolutions():
        our_emb = ours(wav, 16000)[1].ravel()
    cos = float(np.dot(ref_emb, our_emb) / (np.linalg.norm(ref_emb) * np.linalg.norm(our_emb) + 1e-9))
    return CheckResult("speaker", "PASS" if cos > MIN_SPEAKER_COSINE else "FAIL", metric=f"cosine={cos:.5f}",
                       detail=f"threshold > {MIN_SPEAKER_COSINE:g}")


def validate(config_path: str, weights_path: str, dac: str | None = None, speaker: str | None = None,
             lda: str | None = None, device=None) -> list[CheckResult]:
    load, _model = check_load(config_path, weights_path, device=device)
    return [load, check_backbone_parity(config_path, weights_path, device=device), check_dac(dac, device=device),
            check_speaker(speaker, lda, device=device)]


def print_table(results: list[CheckResult]) -> bool:
    """Print the table; True when no row FAILs."""
    w = max(len(r.name) for r in results)
    ok = True
    print(f"\n{'check'.ljust(w)}  status  metric / detail")
    print("-" * 72)
    for r in results:
        line = f"{r.name.ljust(w)}  {r.status:6}  {r.metric}"
        if r.detail:
            line += f"  [{r.detail}]"
        print(line)
        ok &= r.status != "FAIL"
    print("-" * 72)
    print("RESULT:", "PASS" if ok else "FAIL")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--weights", required=True)
    ap.add_argument("--dac", default=None, help="transformers DacModel directory (descript 44 kHz)")
    ap.add_argument("--speaker", default=None, help="ResNet293 speaker checkpoint")
    ap.add_argument("--lda", default=None, help="speaker LDA checkpoint")
    ap.add_argument("--device", help="torch device (default: the card; raises without one)")
    args = ap.parse_args(argv)
    from zonos_tpu_torch import resolve_device

    device = resolve_device(args.device)
    results = validate(args.config, args.weights, dac=args.dac, speaker=args.speaker, lda=args.lda, device=device)
    return 0 if print_table(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
