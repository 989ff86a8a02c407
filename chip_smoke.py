#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (zonos_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases; any failure exits non-zero:
  0. the card: name and power limit (nvidia-smi), TF32 off for every f32 compare;
  1. build every CUDA kernel from zonos_tpu_torch/csrc (one nvcc per source, in
     parallel) and, beside them, the native G2P library (g++);
  2. each decode kernel (K1-K4) against its plain PyTorch version on the card
     at the main path's shapes and the hybrid's (Mamba in_proj 2048 -> 8512,
     out_proj 4096 -> 2048, the Mamba layers' MLP of F 4096), with times (CUDA
     events, median of 50 after warm-up, L2 flushed before each launch by
     writing 256 MB), the least time the card could take, and a PyTorch
     library call of the same function as a yardstick; every kernel but K5/K6
     and its yardstick are timed again after a flush that reads the same
     256 MB (K5), which leaves clean lines in the L2; K3, K3s and K4 give
     bit-equal outputs on two calls;
  3. the streaming probes K5/K6: one int8 [16384, 8192] array summed once by
     each (their own path, launch counts set to 0 before it and checked after
     it), both held exactly to the plain version and torch.sum, with times and
     the achieved rate beside the 3.35 TB/s every bound assumes;
  4. 2-layer models at full width (d 2048): the transformer, and the hybrid
     with one Mamba and one attention layer, each int8 and then int4, on the
     card in bf16 with the kernels against the same weights on the CPU in f32
     with the plain versions: prefill + 8 teacher-forced decode steps, logits
     compared; a 2-layer transformer written as a reference checkpoint and
     read back by from_local, params bit-equal; a short DAC decode compared;
  5. the main path: the flagship transformer (24 layers), int8 weights and KV,
     860 frames (10 s) at cfg 2.0 and min-p 0.1, then the full-size DAC to
     int16 PCM; run twice, the second run timed with every kernel's launch
     count set to 0 before it and checked after it;
  6. the facade path on int4 weights: English text and a speaker vector through
     make_cond_dict, prepare_conditioning (cfg 2.0) and generate_audio (the DAC
     of settled spans interleaved with the decode loop) to 430 frames of int16
     PCM; a warm-up run, then a run with every launch count set to 0 before it
     and checked after it; the phonemes must come from the native G2P engine;
     at greedy, generate_audio against generate + a whole-request DAC decode;
  7. the voice-clone request on phase 5's int8 model: pipeline.tts with a 10 s
     speaker wav (24 kHz, through the full ResNet293 tower) and a 3 s prefix
     wav (44.1 kHz, through the full DAC encoder: 259 frames continued); a
     warm-up request, then one on new file names (cache misses) with every
     launch count set to 0 before it and checked after it; then the speaker
     tower (2 s clip) and the DAC encoder (1 s clip) card against CPU in f32;
  8. the full-size hybrid (Zonos-v0.1-hybrid: 24 layers, attention at 3, 9, 15
     and 21), seeded bf16 weights written as a reference checkpoint (bytes and
     seconds) into a temporary directory, read back by from_local (seconds)
     bit-equal, quantized to int8, and English text through make_cond_dict
     (the hybrid's conditioners), prepare_conditioning and generate_audio to
     430 frames of int16 PCM: a 128-frame warm-up run, then one with every
     launch count set to 0 before it and checked after it (per step K1 49,
     K3 24, K2 4);
  9. a 32-frame generate under torch.profiler on phase 5's int8 model, then
     on phase 6's int4 model, then on phase 8's hybrid: device time (the
     kernels' sum, and the union of their intervals) and kernel launches per
     decode step against the step's wall time from phase 5, 6 or 8, the top
     kernels, and each kernel wrapper's device kernels per call as designed
     (K1, K2 and K4 one, K3 two: fc1 + gate, then fc2).
With ``--parts``, only the device kernels of one K3, K3s or K4 call at the
main path's shapes, each with its device time under torch.profiler.
Prints one line per kernel check, a ``{"kernels": [...]}`` line (``launches``
from phase 5, or phase 6 for K4, and ``launches_by_path`` for phases 5, 6
and 8), the card's name and power limit, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate
REPS = 50


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, flush) -> float:
    """Median device time of fn over REPS launches, each after an L2 flush
    (``flush()``: writing or reading 256 MB; None: no flush).

    A spin kernel queued before each timed launch keeps the card busy while
    the host enqueues it, so the events bracket device time only.
    """
    for _ in range(3):
        fn()
    times = []
    for _ in range(REPS):
        if flush is not None:
            flush()
        torch.cuda._sleep(200_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _corr(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(np.corrcoef(a.double().cpu().numpy().ravel(), b.double().cpu().numpy().ravel())[0, 1])


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

# The hybrid's decode shapes (zonos_v01_hybrid_config): Mamba in_proj
# 2048 -> 8512 and out_proj 4096 -> 2048, and the Mamba layers' MLP of F 4096
# (int4: its fc1 2048 -> 8192 and fc2 4096 -> 2048).
HYBRID_K1 = ((2048, 8512), (4096, 2048))
HYBRID_K4 = ((2048, 8512), (4096, 2048), (2048, 8192))
HYBRID_F = 4096


def _k1_case(M, gen, flush, read_flush, b, k, n, pad_rows16, quantize_int8, tag=""):
    x = torch.randn((b, k), generator=gen, device="cuda").to(torch.bfloat16)
    w = quantize_int8(torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5)
    w["q"] = pad_rows16(w["q"])
    if not M.int8_vector_path(w["q"]):
        _fail(f"K1 B={b} {k}->{n}: the weight does not take the TMA path")
    y = M.int8_matmul(x, w["q"], w["s"])
    ref = M.int8_matmul_plain(x, w["q"], w["s"])
    torch.cuda.synchronize()
    err = (y - ref).abs()
    # Same exact products (bf16 x int8 in f32), only the order of the f32
    # sums differs: rtol 1e-3, atol 1e-3 of the output's largest value.
    tol = 1e-3 * ref.abs() + 1e-3 * ref.abs().max()
    if not bool((err <= tol).all()) or not torch.isfinite(y).all():
        _fail(f"K1 int8_matmul B={b} {k}->{n}: max err {err.max().item():.3e}")
    w_bf16 = (w["q"].float() * w["s"]).to(torch.bfloat16)
    kernel = lambda: M.int8_matmul(x, w["q"], w["s"])  # noqa: E731
    library = lambda: torch.matmul(x, w_bf16)  # noqa: E731
    row = {
        "case": f"{tag}B={b} {k}->{n}", "max_abs_err": err.max().item(),
        "cluster": M.int8_matmul_plan(b, k, n, sms=M._sm_count(x.device)).cluster,
        "ms": _time_ms(kernel, flush),
        "plain_ms": _time_ms(lambda: M.int8_matmul_plain(x, w["q"], w["s"]), flush),
        # yardstick: a bf16 matmul against the pre-dequantized weight (twice the weight bytes)
        "library_ms": _time_ms(library, flush),
        "ms_read_flush": _time_ms(kernel, read_flush),
        "library_ms_read_flush": _time_ms(library, read_flush),
    }
    row["bound_ms"], row["bound_by"] = _bound_ms(k * n + b * k * 2 + n * 4 + b * n * 4, 2 * b * k * n)
    print("K1", json.dumps(row), flush=True)
    return row


def _k1_cases(gen, flush, read_flush):
    from zonos_tpu_torch.ops import cuda_matmul as M
    from zonos_tpu_torch.ops.quant import pad_rows16, quantize_int8

    rows = []
    for b in (2, 16):
        # in_proj, out_proj, and the int8 heads in the port's layout (rows padded to 16 bytes)
        for k, n in ((2048, 3072), (2048, 2048), (2048, 9225)):
            rows.append(_k1_case(M, gen, flush, read_flush, b, k, n, pad_rows16, quantize_int8))
    # the hybrid's Mamba in_proj (N 8512: 33 tiles of 256 and a 64-column tail) and out_proj
    for k, n in HYBRID_K1:
        rows.append(_k1_case(M, gen, flush, read_flush, 2, k, n, pad_rows16, quantize_int8, "hybrid "))
    # The scalar variant (a row stride that is not a multiple of 16 bytes, which
    # no main-path weight has): the heads unpadded, checked only.
    x = torch.randn((3, 2048), generator=gen, device="cuda").to(torch.bfloat16)
    w = quantize_int8(torch.randn((2048, 9225), generator=gen, device="cuda") / 2048 ** 0.5)
    if M.int8_vector_path(w["q"]):
        _fail("K1 scalar case: the unpadded weight takes the TMA path")
    y, ref = M.int8_matmul(x, w["q"], w["s"]), M.int8_matmul_plain(x, w["q"], w["s"])
    torch.cuda.synchronize()
    err = (y - ref).abs()
    if not bool((err <= 1e-3 * ref.abs() + 1e-3 * ref.abs().max()).all()):
        _fail(f"K1 int8_matmul scalar variant B=3 2048->9225: max err {err.max().item():.3e}")
    print("K1", json.dumps({"case": "B=3 2048->9225, row stride 9225 (scalar variant)",
                            "max_abs_err": err.max().item()}), flush=True)
    return rows


def _k2_cases(gen, flush, read_flush):
    from zonos_tpu_torch.models.transformer import _kv_quantize
    from zonos_tpu_torch.ops import cuda_attention as A

    b, hkv, hq, dh = 2, 4, 16, 128
    rows = []
    # the main path's cache (1152 slots, timed), and a cache long enough that
    # each rank walks its share in two bulk-copy stages (checked only)
    for case, s, wi, gap_start, gap in (("mid-cache", 1152, 700, 0, None), ("gap", 1152, 900, 128, [40, 0]),
                                        ("long-cache", 8192, 8000, 0, None)):
        q = torch.randn((b, 1, hq, dh), generator=gen, device="cuda").to(torch.bfloat16)
        kq, ks = _kv_quantize(torch.randn((b, s, hkv, dh), generator=gen, device="cuda") * 2.0)
        vq, vs = _kv_quantize(torch.randn((b, s, hkv, dh), generator=gen, device="cuda"))
        kq, vq = kq.transpose(1, 2).contiguous(), vq.transpose(1, 2).contiguous()
        ks, vs = ks.transpose(1, 2).contiguous(), vs.transpose(1, 2).contiguous()
        pad_host = [3, 17]
        pad = torch.tensor(pad_host, dtype=torch.int32, device="cuda")
        wi_t = torch.tensor([wi], dtype=torch.int32, device="cuda")
        gap_len = None if gap is None else torch.tensor(gap, dtype=torch.int32, device="cuda")
        args = (q, kq, ks, vq, vs, wi_t, pad, gap_start, gap_len)
        out = A.attn_core_int8(*args)
        ref = A.attn_core_int8_plain(*args)
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        corr = _corr(out.float(), ref.float())
        # Both round p = softmax * vs to bf16 after normalising, so they differ
        # only where f32 sums taken in another order move a value across a
        # bf16 rounding boundary: one bf16 ulp of the output (2^-7 |ref| bounds
        # it), plus 2^-12 where a tiny output's last bit follows that order;
        # never looser than the 2e-2 / 0.9995 the two-pass kernel needed.
        tol = torch.clamp(2.0**-7 * ref.float().abs() + 2.0**-12, max=2e-2)
        if not bool((diff <= tol).all()) or corr <= 0.99999:
            _fail(f"K2 attn_core_int8 {case}: max err {err:.3e}, corr {corr:.8f}")
        # yardstick: SDPA on K/V dequantized to bf16, with the same mask
        from zonos_tpu_torch.ops.attention import decode_mask

        mask = decode_mask(s, pad, wi, gap_start=gap_start, gap_len=gap_len)[:, None]  # [B,1,1,S]
        kd = (kq.float() * ks[..., None]).to(torch.bfloat16)
        vd = (vq.float() * vs[..., None]).to(torch.bfloat16)
        qt = q.transpose(1, 2)
        lib = lambda: F.scaled_dot_product_attention(qt, kd, vd, attn_mask=mask, enable_gqa=True)  # noqa: E731
        n_valid = [
            sum(1 for j in range(s) if pad_host[i] <= j <= wi and not (gap is not None and gap_start <= j < gap_start + gap[i]))
            for i in range(b)
        ]
        nbytes = sum(hkv * n * (2 * dh + 2 * 4) for n in n_valid) + 2 * b * hq * dh * 2
        ops = sum(hq * n * dh * 4 for n in n_valid)
        kernel = lambda: A.attn_core_int8(*args)  # noqa: E731
        plan = A.attn_plan(s, hq // hkv)
        row = {"case": case, "max_abs_err": err, "corr": corr, "cluster": plan.cluster,
               "stages": -(-plan.share_cap // plan.stage)}
        if s == 1152:
            row.update({
                "ms": _time_ms(kernel, flush),
                "plain_ms": _time_ms(lambda: A.attn_core_int8_plain(*args), flush),
                "library_ms": _time_ms(lib, flush),
                "ms_read_flush": _time_ms(kernel, read_flush),
                "library_ms_read_flush": _time_ms(lib, read_flush),
            })
        row["bound_ms"], row["bound_by"] = _bound_ms(nbytes, ops)
        rows.append(row)
        print("K2", json.dumps(row), flush=True)
    return rows


def _k3_cases(gen, flush, read_flush):
    from zonos_tpu_torch.ops import cuda_matmul as M
    from zonos_tpu_torch.ops.quant import quantize_int8

    rows = []
    # the flagship MLP (K3 and K3s), then the hybrid's Mamba-layer MLP (K3)
    for b, d, f, names in ((2, 2048, 8192, ("K3", "K3s")), (2, 2048, HYBRID_F, ("K3 hybrid",))):
        rows += _k3_shape(M, quantize_int8, gen, flush, read_flush, b, d, f, names)
    return rows


def _k3_shape(M, quantize_int8, gen, flush, read_flush, b, d, f, names):
    x = torch.randn((b, d), generator=gen, device="cuda").to(torch.bfloat16)
    w1 = quantize_int8(torch.randn((d, 2 * f), generator=gen, device="cuda") / d ** 0.5)
    w2 = quantize_int8(torch.randn((f, d), generator=gen, device="cuda") / f ** 0.5)
    s1 = w1["s"].reshape(-1)
    w1y, w1g = w1["q"][:, :f].contiguous(), w1["q"][:, f:].contiguous()
    s1y, s1g = s1[:f].contiguous(), s1[f:].contiguous()
    fused = lambda: M.fused_mlp_int8(x, w1["q"], w1["s"], w2["q"], w2["s"])  # noqa: E731
    split = lambda: M.fused_mlp_int8_split(x, w1y, s1y, w1g, s1g, w2["q"], w2["s"])  # noqa: E731
    plain = lambda: M.fused_mlp_int8_plain(x, w1["q"], w1["s"], w2["q"], w2["s"])  # noqa: E731
    ref = plain()
    w1_bf16 = (w1["q"].float() * w1["s"]).to(torch.bfloat16)
    w2_bf16 = (w2["q"].float() * w2["s"]).to(torch.bfloat16)

    def library():  # yardstick: the same MLP as bf16 matmuls on pre-dequantized weights
        y, g = torch.matmul(x, w1_bf16).chunk(2, dim=-1)
        return torch.matmul(y * F.silu(g), w2_bf16)

    nbytes = d * 2 * f + f * d + (2 * f + d) * 4 + b * d * 2 + b * d * 4
    ops = 2 * b * d * 2 * f + 2 * b * f * d
    rows = []
    for name, fn in zip(names, (fused, split)):
        out = fn()
        again = fn()
        torch.cuda.synchronize()
        err = (out - ref).abs()
        # h is rounded to bf16 in both; a y or gate summed in another order can
        # round h one bf16 ulp apart: rtol 2e-2, atol 2e-2.
        if not bool((err <= 2e-2 + 2e-2 * ref.abs()).all()) or not torch.isfinite(out).all():
            _fail(f"{name}: max err {err.max().item():.3e}")
        if not torch.equal(out, again):  # sums in a fixed order
            _fail(f"{name}: two calls on the same inputs differ")
        row = {
            "case": f"{name}: B={b} D={d} F={f}", "max_abs_err": err.max().item(),
            "ms": _time_ms(fn, flush), "plain_ms": _time_ms(plain, flush),
            "library_ms": _time_ms(library, flush),
            "ms_read_flush": _time_ms(fn, read_flush), "library_ms_read_flush": _time_ms(library, read_flush),
        }
        row["bound_ms"], row["bound_by"] = _bound_ms(nbytes, ops)
        rows.append((name, row))
        print(name.split()[0], json.dumps(row), flush=True)
    return rows


def _k4_cases(gen, flush, read_flush):
    from zonos_tpu_torch.ops import cuda_matmul as M
    from zonos_tpu_torch.ops.quant import quantize_int4

    rows = []
    # in_proj, out_proj, fc1 and fc2 of a flagship layer at the decode batch,
    # and in_proj at the largest batch K4 takes
    # then the hybrid's Mamba in_proj, out_proj (and fc2) and its Mamba-layer fc1
    shapes = ((2, 2048, 3072), (2, 2048, 2048), (2, 2048, 16384), (2, 8192, 2048), (16, 2048, 3072),
              *((2, k, n) for k, n in HYBRID_K4))
    for i, (b, k, n) in enumerate(shapes):
        x = torch.randn((b, k), generator=gen, device="cuda").to(torch.bfloat16)
        w = quantize_int4(torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5)
        y = M.int4_matmul(x, w["q4"], w["s4"])
        again = M.int4_matmul(x, w["q4"], w["s4"])
        ref = M.int4_matmul_plain(x, w["q4"], w["s4"])
        torch.cuda.synchronize()
        err = (y - ref).abs()
        # Same exact products (bf16 x int4 in f32) and per-group scaling, only
        # the order of the f32 sums differs: K1's bar.
        tol = 1e-3 * ref.abs() + 1e-3 * ref.abs().max()
        if not bool((err <= tol).all()) or not torch.isfinite(y).all():
            _fail(f"K4 int4_matmul B={b} {k}->{n}: max err {err.max().item():.3e}")
        if not torch.equal(y, again):  # sums in a fixed order
            _fail(f"K4 int4_matmul B={b} {k}->{n}: two calls on the same inputs differ")
        g = w["s4"].shape[0]
        w_bf16 = (M.unpack_nibbles(w["q4"], torch.float32) * w["s4"]).reshape(k, n).to(torch.bfloat16)
        kernel = lambda: M.int4_matmul(x, w["q4"], w["s4"])  # noqa: E731
        library = lambda: torch.matmul(x, w_bf16)  # noqa: E731
        row = {
            "case": f"{'hybrid ' if i >= 5 else ''}B={b} {k}->{n}", "max_abs_err": err.max().item(),
            "cluster": M.int4_matmul_plan(b, k, n, 128, sms=M._sm_count(x.device)).cluster,
            "ms": _time_ms(kernel, flush),
            "plain_ms": _time_ms(lambda: M.int4_matmul_plain(x, w["q4"], w["s4"]), flush),
            # yardstick: a bf16 matmul against the pre-dequantized weight (4x the weight bytes)
            "library_ms": _time_ms(library, flush),
            "ms_read_flush": _time_ms(kernel, read_flush), "library_ms_read_flush": _time_ms(library, read_flush),
        }
        row["bound_ms"], row["bound_by"] = _bound_ms(k * n // 2 + g * n * 4 + b * k * 2 + b * n * 4, 2 * b * k * n)
        rows.append(row)
        print("K4", json.dumps(row), flush=True)
    return rows


def _kernel_parts() -> None:
    """``--parts``: each device kernel that one K3, K3s or K4 wrapper call
    launches, with its mean device time under torch.profiler, after a written
    256 MB flush before every call (20 calls per case)."""
    from torch.profiler import ProfilerActivity, profile

    from zonos_tpu_torch.ops import _build
    from zonos_tpu_torch.ops import cuda_matmul as M
    from zonos_tpu_torch.ops.quant import quantize_int4, quantize_int8

    _build.build_all()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    buf = torch.zeros(256 * 2**20, dtype=torch.uint8, device="cuda")
    cases = []
    for b in (2, 16):
        d, f = 2048, 8192
        x = torch.randn((b, d), generator=gen, device="cuda").to(torch.bfloat16)
        w1 = quantize_int8(torch.randn((d, 2 * f), generator=gen, device="cuda") / d ** 0.5)
        w2 = quantize_int8(torch.randn((f, d), generator=gen, device="cuda") / f ** 0.5)
        s1 = w1["s"].reshape(-1)
        w1y, w1g = w1["q"][:, :f].contiguous(), w1["q"][:, f:].contiguous()
        s1y, s1g = s1[:f].contiguous(), s1[f:].contiguous()
        cases.append((f"K3 B={b}", lambda x=x, w1=w1, w2=w2: M.fused_mlp_int8(x, w1["q"], w1["s"], w2["q"], w2["s"])))
        if b == 2:
            cases.append((f"K3s B={b}", lambda x=x, a=(w1y, s1y, w1g, s1g, w2["q"], w2["s"]): M.fused_mlp_int8_split(x, *a)))
    for b, k, n in ((2, 2048, 3072), (2, 2048, 2048), (2, 2048, 16384), (2, 8192, 2048), (16, 2048, 3072)):
        x = torch.randn((b, k), generator=gen, device="cuda").to(torch.bfloat16)
        w = quantize_int4(torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5)
        cases.append((f"K4 B={b} {k}->{n}", lambda x=x, w=w: M.int4_matmul(x, w["q4"], w["s4"])))
    calls = 20
    for name, fn in cases:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                buf.zero_()
                fn()
            torch.cuda.synchronize()
        parts = [{"kernel": e.key[:60], "per_call": e.count / calls, "us": e.self_device_time_total / e.count}
                 for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA and e.count and "Fill" not in e.key]
        print("parts", name, json.dumps({"card": _card_line(), "kernels": parts,
                                         "us_per_call": sum(p["us"] * p["per_call"] for p in parts)}), flush=True)


# ---------------------------------------------------------------------------
# Phase 3: the streaming probes K5/K6
# ---------------------------------------------------------------------------

STREAM_SHAPE, STREAM_BLK = (16384, 8192), 512  # tools/bench_stream.py's array and block


def _k56_cases(gen, flush):
    """K5/K6 on their own path (one sum each, counted), then held exactly to
    the plain version and torch.sum, and timed. Returns ({name: launches on
    the path}, {name: row})."""
    from zonos_tpu_torch.ops import stream_sum as S

    r, c = STREAM_SHAPE
    w = torch.randint(-127, 127, (r, c), generator=gen, device="cuda", dtype=torch.int8)
    probes = (S.grid_sum_once, S.manual_sum_once)
    for k in probes:
        k.launches = 0
    path_out = {k.__name__: k(w, STREAM_BLK) for k in probes}
    counts = {k.__name__: k.launches for k in probes}
    if counts != {k.__name__: 1 for k in probes}:
        _fail(f"phase 3: probe launch counts {counts}")

    lib = lambda: torch.sum(w, dtype=torch.int32)  # noqa: E731
    expect = int(lib())
    wrap = torch.full((4096, 4352), 127, dtype=torch.int8, device="cuda")  # 2,263,875,584 wraps past 2**31
    wrap_expect = 2_263_875_584 - 2**32
    rows = {}
    for k in probes:
        name = k.__name__
        got = {"path": int(path_out[name]), "again": int(k(w, STREAM_BLK)),
               "plain": int(S.stream_sum_plain(w, STREAM_BLK)), "torch.sum": expect}
        wrapped = {"kernel": int(k(wrap, STREAM_BLK)), "plain": int(S.stream_sum_plain(wrap, STREAM_BLK)),
                   "torch.sum": int(torch.sum(wrap, dtype=torch.int32))}
        if len(set(got.values())) != 1 or set(wrapped.values()) != {wrap_expect}:
            _fail(f"phase 3: {name} sums {got}, wrapping case {wrapped} (expected {wrap_expect})")
        # The array is 2.7x the L2, so no flush: a written flush buffer leaves
        # dirty L2 lines whose write-back lands inside the timed launch
        # (timed once with it, for the size of that effect).
        timed = []
        for blk in (STREAM_BLK, 64):
            ms = _time_ms(lambda: k(w, blk), None)
            timed.append({"blk": blk, "ms": ms, "gb_per_s": r * c / ms / 1e6})
        row = {"case": f"[{r}, {c}] int8, blk {STREAM_BLK}", "max_abs_err": 0.0, "sum": got["path"],
               "ms": timed[0]["ms"], "gb_per_s": timed[0]["gb_per_s"], "blk_64": timed[1],
               "ms_after_written_flush": _time_ms(lambda: k(w, STREAM_BLK), flush),
               "plain_ms": _time_ms(lambda: S.stream_sum_plain(w, STREAM_BLK), None),
               "library_ms": _time_ms(lib, None), "assumed_gb_per_s": HBM_BYTES_PER_S / 1e9}
        row["bound_ms"], row["bound_by"] = _bound_ms(r * c + 4, r * c)
        rows[name] = row
        print("phase3", name, json.dumps(row), flush=True)
    return counts, rows


# ---------------------------------------------------------------------------
# Phase 4: two full-width layers, card (bf16, kernels) vs CPU (f32, plain)
# ---------------------------------------------------------------------------

def _phase_small_model(bits: int, hybrid: bool = False):
    from zonos_tpu_torch.bridge import params_from_jax
    from zonos_tpu_torch.config import zonos_v01_hybrid_config, zonos_v01_transformer_config
    from zonos_tpu_torch.models.backbone import backbone_forward, create_cache
    from zonos_tpu_torch.models.zonos import Zonos
    from zonos_tpu_torch.ops.sampling import SamplingParams
    from zonos_tpu_torch.runtime.generate import GenerateStatics, _decode_logits, apply_heads, embed_codes

    # two layers at full width: both attention, or (hybrid) one Mamba layer and one attention layer
    full = zonos_v01_hybrid_config() if hybrid else zonos_v01_transformer_config()
    cfg = dataclasses.replace(full, backbone=dataclasses.replace(full.backbone, n_layer=2,
                                                                 attn_layer_idx=(1,) if hybrid else (0, 1)))
    cpu = Zonos.from_config(cfg, seed=1, dtype=torch.float32, device="cpu").quantize(bits=bits)
    card_params = params_from_jax(_to_numpy(cpu.params), device="cuda", dtype=torch.bfloat16)
    statics = GenerateStatics(cfg=cfg, sampling=SamplingParams(temperature=0.0), prefill_len=128,
                              delayed_len=1024, cache_len=1152, batch_size=1, kv_int8=True)
    cond = np.random.default_rng(1).normal(size=(2, 80, 2048)).astype(np.float32) * 0.05
    n_q = cfg.codebook_dimension

    def prefill(params, device, dtype):
        x_cond = torch.nn.functional.pad(torch.as_tensor(cond, device=device).to(dtype), (0, 0, 47, 0))
        first = torch.full((1, n_q, 1), cfg.masked_token_id, dtype=torch.int32, device=device)
        pre = embed_codes(params["embeddings"], first)
        x = torch.cat([x_cond, torch.cat([pre, pre], 0)], dim=1)
        pad = torch.full((2,), 47, dtype=torch.int32, device=device)
        cache = create_cache(cfg.backbone, 2, 1152, dtype=dtype, kv_int8=True, device=device)
        h, cache = backbone_forward(params["backbone"], cfg.backbone, x, cache, 0, pad, 128)
        lg = apply_heads(params["heads"], h[:, -1:], n_q)[:, :, 0]
        return lg[:1] * 2.0 - lg[1:], cache, pad  # uncond + (cond - uncond) * 2

    with torch.no_grad():
        lg_cpu, cache_cpu, pad_cpu = prefill(cpu.params, "cpu", torch.float32)
        lg_gpu, cache_gpu, pad_gpu = prefill(card_params, "cuda", torch.bfloat16)
        corrs = [_corr(lg_gpu, lg_cpu)]
        for t in range(8):
            frame = lg_cpu.argmax(-1).to(torch.int32)[..., None]  # teacher-forced from the CPU run
            lg_cpu, _ = _decode_logits(cpu.params, statics, frame, cache_cpu, 128 + t, pad_cpu, 2.0)
            lg_gpu, _ = _decode_logits(card_params, statics, frame.cuda(), cache_gpu, 128 + t, pad_gpu, 2.0)
            corrs.append(_corr(lg_gpu, lg_cpu))
    label = f"{'hybrid ' if hybrid else ''}int{bits}"
    print(f"phase4 {label} logits corr (prefill, 8 decode steps):", json.dumps([round(c, 6) for c in corrs]),
          flush=True)
    # bf16 activations, KV (and SSD states) on the card against f32 on the CPU: corr > 0.999
    if min(corrs) <= 0.999:
        _fail(f"phase 4: 2-layer {label} card/CPU logits correlation {min(corrs):.6f} <= 0.999")


REF_EMB_ROWS = 1026  # the embedding rows a reference checkpoint holds (1032 in memory, padded with zeros)


def _checkpoint_round_trip(model, label: str):
    """Write ``model`` with ``save_reference_checkpoint`` into a temporary
    directory (removed whatever happens), load it back with ``from_local``
    on the card, and require every param bit-equal (the embeddings on their
    1026 reference rows, the padding rows zero). Returns (the loaded model,
    sizes and times)."""
    from zonos_tpu_torch.models.zonos import Zonos
    from zonos_tpu_torch.utils.export import save_reference_checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        t = time.perf_counter()
        wpath, cpath = save_reference_checkpoint(tmp, model.params, model.config)
        write_s = time.perf_counter() - t
        t = time.perf_counter()
        loaded = Zonos.from_local(cpath, wpath, dtype=model.dtype, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        nbytes = os.path.getsize(wpath)
    bad = _tree_diff(model.params, loaded.params)
    if loaded.config != model.config or bad:
        _fail(f"{label}: the checkpoint read back differs: config equal {loaded.config == model.config}, "
              f"params {bad[:5]}")
    info = {"bytes": nbytes, "write_s": write_s, "load_s": load_s,
            "params": sum(t.numel() for t in _leaves(model.params))}
    print(f"{label} checkpoint write/load, params bit-equal:", json.dumps(info), flush=True)
    return loaded, info


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def _tree_diff(a, b, path="") -> list:
    """Paths where two params trees differ (dtype, shape or any bit)."""
    if isinstance(a, dict):
        if set(a) != set(b):
            return [f"{path}: keys {sorted(set(a) ^ set(b))}"]
        return [d for k in a for d in _tree_diff(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, list):
        return [d for i, (u, v) in enumerate(zip(a, b)) for d in _tree_diff(u, v, f"{path}[{i}]")]
    if a is None or b is None:
        return [] if a is None and b is None else [path]
    if path == "/embeddings":
        if b[:, REF_EMB_ROWS:].any():
            return [f"{path}: padding rows not zero"]
        a, b = a[:, :REF_EMB_ROWS], b[:, :REF_EMB_ROWS]
    return [] if a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b) else [path]


def _phase_small_checkpoint():
    """A 2-layer full-width transformer (bf16, seeded) through the reference
    checkpoint and back on the card."""
    from zonos_tpu_torch.config import zonos_v01_transformer_config
    from zonos_tpu_torch.models.zonos import Zonos

    full = zonos_v01_transformer_config()
    cfg = dataclasses.replace(full, backbone=dataclasses.replace(full.backbone, n_layer=2, attn_layer_idx=(0, 1)))
    _checkpoint_round_trip(Zonos.from_config(cfg, seed=2, dtype=torch.bfloat16, device="cuda"),
                           "phase4 2-layer transformer")


def _phase_small_dac():
    from zonos_tpu_torch.bridge import params_from_jax
    from zonos_tpu_torch.codec.dac import DACAutoencoder

    dac_gpu = DACAutoencoder(dtype=torch.bfloat16, frame_bucket=16, device="cuda", seed=3)
    dac_cpu = DACAutoencoder(params=params_from_jax(_to_numpy(dac_gpu.params), device="cpu"),
                             dtype=torch.float32, frame_bucket=16, device="cpu")
    codes = np.random.default_rng(2).integers(0, 1024, size=(1, 9, 16)).astype(np.int32)
    wav_gpu, wav_cpu = dac_gpu.decode(codes), dac_cpu.decode(codes)
    c = _corr(torch.as_tensor(wav_gpu), torch.as_tensor(wav_cpu))
    print(f"phase4 DAC 16 frames card bf16 vs CPU f32: corr {c:.6f}", flush=True)
    if not np.isfinite(wav_gpu).all() or c <= 0.99:  # bf16 convolutions through 4 upsampling blocks
        _fail(f"phase 4: DAC card/CPU correlation {c:.6f} <= 0.99")


def _to_numpy(tree):
    """Params tree of tensors → numpy (bf16 widened to f32, int8 kept), for the bridge."""
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_numpy(v) for v in tree]
    if tree is None:
        return None
    return (tree.float() if tree.dtype == torch.bfloat16 else tree).cpu().numpy()


# ---------------------------------------------------------------------------
# Phase 5: the main path at full size
# ---------------------------------------------------------------------------

def _phase_main_path(card: str):
    from zonos_tpu_torch.config import zonos_v01_transformer_config
    from zonos_tpu_torch.models.zonos import Zonos
    from zonos_tpu_torch.ops import cuda_attention as A
    from zonos_tpu_torch.ops import cuda_matmul as M
    from zonos_tpu_torch.ops.sampling import SamplingParams

    cfg = zonos_v01_transformer_config()
    t0 = time.perf_counter()
    model = Zonos.from_config(cfg, seed=0, dtype=torch.bfloat16, device="cuda").quantize()
    ae = model.autoencoder
    torch.cuda.synchronize()
    print(f"phase5 model init + int8 quantize: {time.perf_counter() - t0:.1f} s", flush=True)
    heads = model.params["heads"]["q"]
    if not M.int8_vector_path(heads):  # rows padded to 16 bytes: K1 reads the heads by TMA
        _fail(f"phase 5: the int8 heads {tuple(heads.shape)} (row stride {heads.stride(0)}) miss the TMA path")
    cond = np.random.default_rng(0).normal(size=(2, 80, cfg.backbone.d_model)).astype(np.float32) * 0.05
    frames = 860

    def run(seed):
        stats = {}
        t = time.perf_counter()
        codes = model.generate(cond, max_new_tokens=frames, cfg_scale=2.0, seed=seed,
                               sampling_params=SamplingParams(min_p=0.1), forbid_eos=True,
                               kv_int8=True, stats=stats)
        t_gen = time.perf_counter() - t
        t = time.perf_counter()
        pcm = ae.decode_device(codes, to_int16=True).cpu().numpy()
        return codes, pcm, stats, t_gen, time.perf_counter() - t

    with torch.no_grad():
        run(1)  # warm-up: kernel libraries loaded, cuDNN plans picked
        kernels = (M.int8_matmul, A.attn_core_int8, M.fused_mlp_int8, M.fused_mlp_int8_split, M.int4_matmul)
        for k in kernels:
            k.launches = 0
        codes, pcm, stats, t_gen, t_dac = run(2)
        counts = {k.__name__: k.launches for k in kernels}

    steps, L = stats["decode_steps"], cfg.backbone.n_layer
    # per decode step: in_proj + out_proj per layer and the output heads on K1,
    # one K2 and one K3 per layer; the prefill's last-position heads on K1.
    expected = {"int8_matmul": steps * (2 * L + 1) + 1, "attn_core_int8": steps * L,
                "fused_mlp_int8": steps * L, "fused_mlp_int8_split": 0, "int4_matmul": 0}
    print("phase5 launches:", json.dumps(counts), "expected:", json.dumps(expected), flush=True)
    if counts != expected:
        _fail(f"phase 5: launch counts {counts} != expected {expected}")
    if codes.shape != (1, cfg.codebook_dimension, frames) or codes.min() < 0 or codes.max() > 1023:
        _fail(f"phase 5: codes shape {codes.shape}, range [{codes.min()}, {codes.max()}]")
    if pcm.shape != (1, frames * 512) or pcm.dtype != np.int16:
        _fail(f"phase 5: PCM shape {pcm.shape} dtype {pcm.dtype}")
    audio_s = frames * 512 / 44100
    result = {
        "card": card, "frames": frames, "audio_s": audio_s, "decode_steps": steps,
        "prefill_ms": stats["prefill_s"] * 1e3,
        "decode_ms_per_frame": stats["decode_s"] * 1e3 / steps,
        "generate_s": t_gen, "dac_ms": t_dac * 1e3, "rtf": audio_s / (t_gen + t_dac),
        "pcm_rms": float(np.sqrt(np.mean(pcm.astype(np.float64) ** 2))),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    print("phase5 main path:", json.dumps(result), flush=True)
    return counts, model, cond, result


# ---------------------------------------------------------------------------
# Phase 6: the facade path on int4 weights, text to PCM
# ---------------------------------------------------------------------------

FACADE_TEXT = ("The quick brown fox jumps over the lazy dog near the riverbank, "
               "while 3 children count the boats drifting slowly past the old mill.")
FACADE_FRAMES = 430  # 5 s of audio at 86 frames per second


def _phase_facade_int4(card: str):
    from zonos_tpu_torch.conditioning import espeak, native_g2p
    from zonos_tpu_torch.conditioning.cond_dict import make_cond_dict
    from zonos_tpu_torch.conditioning.text import clean
    from zonos_tpu_torch.config import zonos_v01_transformer_config
    from zonos_tpu_torch.models.zonos import Zonos
    from zonos_tpu_torch.ops import cuda_attention as A
    from zonos_tpu_torch.ops import cuda_matmul as M
    from zonos_tpu_torch.ops.sampling import SamplingParams

    # The phonemes must come from the native rule engine: not from the
    # grapheme fallback, and not from a system eSpeak.
    fallbacks = []
    warn = espeak._warn_grapheme_fallback
    espeak._warn_grapheme_fallback = lambda lang: (fallbacks.append(lang), warn(lang))
    phonemes = espeak.phonemize([FACADE_TEXT], ["en-us"])[0]
    native = native_g2p.phonemize(clean([FACADE_TEXT], ["en-us"])[0], "en-us")
    print("phase6 phonemes:", json.dumps(phonemes, ensure_ascii=False), flush=True)
    if fallbacks or native is None or phonemes != native:
        _fail(f"phase 6: phonemes did not come from the native G2P engine (fallback for {fallbacks})")

    cfg = zonos_v01_transformer_config()
    L = cfg.backbone.n_layer
    t0 = time.perf_counter()
    model = Zonos.from_config(cfg, seed=0, dtype=torch.bfloat16, device="cuda").quantize(bits=4)
    torch.cuda.synchronize()
    print(f"phase6 model init + int4 quantize: {time.perf_counter() - t0:.1f} s", flush=True)
    speaker = np.random.default_rng(4).normal(size=(1, 1, 128)).astype(np.float32)
    cd = make_cond_dict(text=FACADE_TEXT, language="en-us", speaker=speaker)

    def conditioning():
        torch.cuda.synchronize()
        t = time.perf_counter()
        cond = model.prepare_conditioning(cd, cfg_scale=2.0)
        torch.cuda.synchronize()
        return cond, time.perf_counter() - t

    def run(seed, sampling):
        stats = {}
        t = time.perf_counter()
        wav, lengths = model.generate_audio(cond, max_new_tokens=FACADE_FRAMES, cfg_scale=2.0,
                                            sampling_params=sampling, seed=seed, forbid_eos=True,
                                            pcm_int16=True, stats=stats)
        return wav, lengths, stats, time.perf_counter() - t

    kernels = (M.int4_matmul, M.int8_matmul, A.attn_core_int8, M.fused_mlp_int8, M.fused_mlp_int8_split)
    with torch.no_grad():
        cond, _ = conditioning()
        run(1, SamplingParams(min_p=0.1))  # warm-up
        cond, t_cond = conditioning()
        torch.cuda.reset_peak_memory_stats()
        for k in kernels:
            k.launches = 0
        wav, lengths, stats, t_total = run(2, SamplingParams(min_p=0.1))
        counts = {k.__name__: k.launches for k in kernels}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9

        # Greedy: the pipelined path against generate + a whole-request DAC decode.
        greedy = SamplingParams(temperature=0.0)
        torch.cuda.synchronize()
        t = time.perf_counter()
        codes, seq_lengths = model.generate(cond, max_new_tokens=FACADE_FRAMES, cfg_scale=2.0, sampling_params=greedy,
                                            seed=0, forbid_eos=True, return_lengths=True)
        t_gen = time.perf_counter() - t
        model.autoencoder.decode_device(codes, to_int16=True).cpu()  # first call at this shape: cuDNN set-up
        t = time.perf_counter()
        pcm_seq = model.autoencoder.decode_device(codes, to_int16=True).cpu().numpy()
        t_dac = time.perf_counter() - t
        pcm_pipe, pipe_lengths, _, _ = run(0, greedy)

    steps = stats["decode_steps"]
    # per decode step: the four int4 projections of every layer on K4, the
    # int8 heads on K1, one K2 per layer; the prefill's last-position heads on K1.
    expected = {"int4_matmul": steps * 4 * L, "int8_matmul": steps + 1, "attn_core_int8": steps * L,
                "fused_mlp_int8": 0, "fused_mlp_int8_split": 0}
    print("phase6 launches:", json.dumps(counts), "expected:", json.dumps(expected), flush=True)
    if counts != expected:
        _fail(f"phase 6: launch counts {counts} != expected {expected}")
    hop, sr = model.autoencoder.config.hop_length, model.autoencoder.sampling_rate
    if wav.shape != (1, FACADE_FRAMES * hop) or wav.dtype != np.int16 or list(lengths) != [FACADE_FRAMES]:
        _fail(f"phase 6: PCM shape {wav.shape} dtype {wav.dtype} lengths {lengths}")
    rms = float(np.sqrt(np.mean(wav.astype(np.float64) ** 2)))

    if list(pipe_lengths) != list(seq_lengths) or pcm_pipe.shape != pcm_seq.shape:
        _fail(f"phase 6: greedy lengths {pipe_lengths} vs {seq_lengths}, shapes {pcm_pipe.shape} vs {pcm_seq.shape}")
    diff = np.abs(pcm_pipe.astype(np.int32) - pcm_seq.astype(np.int32))
    corr = _corr(torch.as_tensor(pcm_pipe), torch.as_tensor(pcm_seq))
    greedy_cmp = {"max_lsb": int(diff.max()), "equal_share": float((diff == 0).mean()), "corr": corr}
    print("phase6 greedy generate_audio vs generate + decode:", json.dumps(greedy_cmp), flush=True)
    # bf16 convolutions summed in another order for another piece shape
    if greedy_cmp["max_lsb"] > 4 and corr <= 0.9999:
        _fail(f"phase 6: pipelined and sequential greedy PCM differ: {greedy_cmp}")

    audio_s = FACADE_FRAMES * hop / sr
    result = {
        "card": card, "frames": FACADE_FRAMES, "audio_s": audio_s, "decode_steps": steps,
        "conditioning_ms": t_cond * 1e3, "prefill_ms": stats["prefill_s"] * 1e3,
        "decode_ms_per_frame": stats["segments_s"] * 1e3 / steps, "dac_host_ms": stats["dac_s"] * 1e3,
        "generate_audio_s": t_total, "rtf": audio_s / t_total, "rtf_with_conditioning": audio_s / (t_total + t_cond),
        "sequential_generate_s": t_gen, "sequential_dac_ms": t_dac * 1e3,
        "sequential_rtf": audio_s / (t_gen + t_dac), "pcm_rms": rms, "peak_mem_gb": peak_gb,
    }
    print("phase6 facade int4 path:", json.dumps(result), flush=True)
    return counts, model, cond, result


# ---------------------------------------------------------------------------
# Phase 7: the voice-clone request through pipeline.tts
# ---------------------------------------------------------------------------

VOICE_TEXT = "Well met, traveler. The road north is dangerous after the first snow."


def _voice(seconds: float, sr: int, seed: int) -> np.ndarray:
    """A seeded voice-like test signal: a gliding harmonic series at a
    syllable-rate amplitude, with a little noise; float32 in (-1, 1)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = 120 + 30 * np.sin(2 * np.pi * 0.7 * t) + rng.uniform(-5, 5)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    wav = sum(np.sin(h * phase) / h for h in range(1, 12))
    wav *= 0.5 + 0.5 * np.abs(np.sin(2 * np.pi * 3.5 * t))
    wav = 0.2 * wav / np.abs(wav).max() + 0.01 * rng.normal(size=t.shape)
    return wav.astype(np.float32)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return None if tree is None else tree.to(device)


def _phase_voice_clone(card: str, model):
    from zonos_tpu_torch.audio.io import read_wav, write_wav
    from zonos_tpu_torch.audio.resample import resample_poly
    from zonos_tpu_torch.codec import dac as D
    from zonos_tpu_torch.ops import cuda_attention as A
    from zonos_tpu_torch.ops import cuda_matmul as M
    from zonos_tpu_torch.ops import stream_sum as S
    from zonos_tpu_torch.serving import pipeline
    from zonos_tpu_torch.serving.caches import get_prefix_cache
    from zonos_tpu_torch.speaker.embedding import SpeakerEmbeddingLDA, default_speaker_model

    L = model.config.backbone.n_layer
    ae = model.autoencoder
    hop = ae.config.hop_length
    kernels = (M.int8_matmul, A.attn_core_int8, M.fused_mlp_int8, M.fused_mlp_int8_split, M.int4_matmul,
               S.grid_sum_once, S.manual_sum_once)
    spk_wav, pre_wav = _voice(10.0, 24000, seed=11), _voice(3.0, 44100, seed=12)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp, torch.no_grad():
        os.chdir(tmp)  # the request's caches (cache/) and wav files live here
        try:
            for name in ("warm", "timed"):
                write_wav(f"speaker_{name}.wav", spk_wav, 24000)
                write_wav(f"prefix_{name}.wav", pre_wav, 44100)

            def request(name, stats=None):
                return pipeline.tts(model, VOICE_TEXT, speaker_audio=f"speaker_{name}.wav",
                                    prefix_audio=f"prefix_{name}.wav", randomize_seed=False, seed=420,
                                    output_path=f"out_{name}.wav", stats=stats)

            request("warm")  # the speaker model's init, cuDNN plans for the tower and the encoder
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for k in kernels:
                k.launches = 0
            stats = {}
            t = time.perf_counter()
            path, wav, sr, rtf = request("timed", stats)  # new file names: both caches miss
            t_total = time.perf_counter() - t
            counts = {k.__name__: k.launches for k in kernels}
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            back, back_sr = read_wav(path)
            prefix_frames = int(get_prefix_cache().get("prefix_timed").shape[-1])
        finally:
            os.chdir(cwd)

    steps = stats["decode_steps"]
    # as phase 5: K1 for in_proj, out_proj and the heads of every step and the
    # prefill's heads; one K2 and one K3 per layer and step
    expected = {"int8_matmul": steps * (2 * L + 1) + 1, "attn_core_int8": steps * L, "fused_mlp_int8": steps * L,
                "fused_mlp_int8_split": 0, "int4_matmul": 0, "grid_sum_once": 0, "manual_sum_once": 0}
    print("phase7 launches:", json.dumps(counts), "expected:", json.dumps(expected), flush=True)
    if counts != expected:
        _fail(f"phase 7: launch counts {counts} != expected {expected}")
    frames = wav.shape[0] // hop
    if prefix_frames != 259:
        _fail(f"phase 7: a 3 s prefix at 44.1 kHz gave {prefix_frames} frames, not 259")
    if (sr != ae.sampling_rate or wav.dtype != np.int16 or wav.shape[0] % hop or frames <= prefix_frames
            or back.shape != (1, wav.shape[0]) or back_sr != sr):
        _fail(f"phase 7: wav {wav.shape} {wav.dtype} at {sr} Hz, file {back.shape} at {back_sr} Hz")

    # Device time of the two front ends alone, on the request's inputs.
    spk = default_speaker_model("cuda")
    spk_in = torch.as_tensor(spk._bucket_pad(resample_poly(spk_wav, 24000, spk.SAMPLE_RATE)[None]), device="cuda")
    pre_in = torch.as_tensor(ae.preprocess(pre_wav[None], 44100), device="cuda")
    tower_ms = _time_ms(lambda: spk.embed_device(spk_in), None)
    encode_ms = _time_ms(lambda: ae.encode_device(pre_in), None)

    # The card against the CPU in f32 (TF32 off), on the same weights.
    with torch.no_grad():
        cpu_spk = SpeakerEmbeddingLDA(params=_tree_to(spk.params, "cpu"), lda=_tree_to(spk.lda, "cpu"),
                                      device="cpu")
        clip = _voice(2.0, 16000, seed=13)
        (e_gpu, l_gpu), (e_cpu, l_cpu) = spk(clip, 16000), cpu_spk(clip, 16000)
        spk_corr = min(_corr(torch.as_tensor(e_gpu), torch.as_tensor(e_cpu)),
                       _corr(torch.as_tensor(l_gpu), torch.as_tensor(l_cpu)))
        wav1 = ae.preprocess(_voice(1.0, 44100, seed=14)[None], 44100)
        ratios = ae.config.downsampling_ratios
        z_gpu = D.encoder_forward(ae.params["encoder"], torch.as_tensor(wav1, device="cuda"), ratios)
        z_cpu = D.encoder_forward(_tree_to(ae.params["encoder"], "cpu"), torch.as_tensor(wav1), ratios)
        c_gpu = D.quantizer_encode(ae.params["quantizer"], z_gpu).cpu()
        c_cpu = D.quantizer_encode(_tree_to(ae.params["quantizer"], "cpu"), z_cpu)
    z_corr = _corr(z_gpu, z_cpu)
    agree = [float((c_gpu[:, i] == c_cpu[:, i]).float().mean()) for i in range(c_gpu.shape[1])]
    cmp = {"speaker_2s_corr": spk_corr, "dac_latent_1s_corr": z_corr, "codebook_agreement": agree}
    print("phase7 card vs CPU (f32):", json.dumps(cmp), flush=True)
    if not (np.isfinite(e_gpu).all() and np.isfinite(l_gpu).all()) or spk_corr < 0.999:
        _fail(f"phase 7: speaker embedding card/CPU correlation {spk_corr:.6f} < 0.999")
    # the RVQ's argmax can flip on a near-tie: codebook 0 is held to 95%
    if not torch.isfinite(z_gpu).all() or z_corr < 0.999 or agree[0] < 0.95:
        _fail(f"phase 7: DAC encoder card/CPU latent corr {z_corr:.6f}, codebook agreement {agree}")

    audio_s = wav.shape[0] / sr
    new_s = (frames - prefix_frames) * hop / sr
    result = {
        "card": card, "text_chars": len(VOICE_TEXT), "prefix_frames": prefix_frames, "frames": frames,
        "audio_s": audio_s, "generated_audio_s": new_s, "decode_steps": steps,
        "speaker_ms": stats["speaker_s"] * 1e3, "speaker_tower_device_ms": tower_ms,
        "prefix_encode_ms": stats["prefix_s"] * 1e3, "dac_encode_device_ms": encode_ms,
        "prefill_ms": stats["prefill_s"] * 1e3, "decode_ms_per_frame": stats["segments_s"] * 1e3 / steps,
        "dac_host_ms": stats["dac_s"] * 1e3, "request_s": t_total, "rtf": audio_s / t_total,
        "rtf_generated": new_s / t_total, "pipeline_rtf": rtf, "peak_mem_gb": peak_gb,
    }
    print("phase7 voice-clone request:", json.dumps(result), flush=True)


# ---------------------------------------------------------------------------
# Phase 8: the full-size hybrid, from a checkpoint on disk
# ---------------------------------------------------------------------------

HYBRID_TEXT = "Across the frozen lake, the lanterns of the village flickered as the evening bells began to ring."


def _phase_hybrid(card: str):
    """Zonos-v0.1-hybrid at full size (seeded bf16 weights) written as a
    reference checkpoint, read back by ``from_local`` bit-equal, quantized to
    int8 and driven text → ``prepare_conditioning`` (the hybrid's
    conditioners) → ``generate_audio`` to 430 frames of int16 PCM: a 128-frame
    warm-up run, then one with every launch count set to 0 before it and
    read after."""
    from zonos_tpu_torch.conditioning.cond_dict import make_cond_dict
    from zonos_tpu_torch.config import zonos_v01_hybrid_config
    from zonos_tpu_torch.models.hybrid import layer_groups
    from zonos_tpu_torch.models.zonos import Zonos
    from zonos_tpu_torch.ops import cuda_attention as A
    from zonos_tpu_torch.ops import cuda_matmul as M
    from zonos_tpu_torch.ops.sampling import SamplingParams

    cfg = zonos_v01_hybrid_config()
    groups = layer_groups(cfg.backbone)
    n_attn = sum(kind == "attn" for kind, _ in groups)
    n_mamba = cfg.backbone.n_layer - n_attn
    t0 = time.perf_counter()
    seeded = Zonos.from_config(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    loaded, ckpt = _checkpoint_round_trip(seeded, "phase8 hybrid")
    del seeded
    model = loaded.quantize()
    del loaded
    speaker = np.random.default_rng(5).normal(size=(1, 1, 128)).astype(np.float32)
    kernels = (M.int8_matmul, A.attn_core_int8, M.fused_mlp_int8, M.fused_mlp_int8_split, M.int4_matmul)

    def run(seed, frames=FACADE_FRAMES):
        stats = {}
        t = time.perf_counter()
        wav, lengths = model.generate_audio(cond, max_new_tokens=frames, cfg_scale=2.0,
                                            sampling_params=SamplingParams(min_p=0.1), seed=seed, forbid_eos=True,
                                            pcm_int16=True, stats=stats)
        return wav, lengths, stats, time.perf_counter() - t

    with torch.no_grad():
        cond = model.prepare_conditioning(make_cond_dict(text=HYBRID_TEXT, language="en-us", speaker=speaker),
                                          cfg_scale=2.0)
        run(1, frames=128)  # warm-up, short: the run is past ~600 s of command time on slower hosts
        torch.cuda.reset_peak_memory_stats()
        for k in kernels:
            k.launches = 0
        wav, lengths, stats, t_total = run(2)
        counts = {k.__name__: k.launches for k in kernels}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9

    steps = stats["decode_steps"]
    # per decode step: Mamba and attention in_proj and out_proj and the heads on
    # K1, every layer's MLP on K3, K2 in the attention layers; the prefill's
    # last-position heads on K1
    expected = {"int8_matmul": steps * (2 * cfg.backbone.n_layer + 1) + 1, "attn_core_int8": steps * n_attn,
                "fused_mlp_int8": steps * cfg.backbone.n_layer, "fused_mlp_int8_split": 0, "int4_matmul": 0}
    print("phase8 launches:", json.dumps(counts), "expected:", json.dumps(expected),
          "per step:", json.dumps({k: v / steps for k, v in counts.items()}), flush=True)
    if counts != expected or (n_mamba, n_attn) != (20, 4):
        _fail(f"phase 8: launch counts {counts} != expected {expected}")
    hop, sr = model.autoencoder.config.hop_length, model.autoencoder.sampling_rate
    if wav.shape != (1, FACADE_FRAMES * hop) or wav.dtype != np.int16 or list(lengths) != [FACADE_FRAMES]:
        _fail(f"phase 8: PCM shape {wav.shape} dtype {wav.dtype} lengths {lengths}")
    rms = float(np.sqrt(np.mean(wav.astype(np.float64) ** 2)))
    if not rms > 0:
        _fail("phase 8: silent PCM")
    audio_s = FACADE_FRAMES * hop / sr
    result = {
        "card": card, "frames": FACADE_FRAMES, "audio_s": audio_s, "decode_steps": steps,
        "init_s": init_s, "checkpoint_bytes": ckpt["bytes"], "checkpoint_write_s": ckpt["write_s"],
        "checkpoint_load_s": ckpt["load_s"], "params": ckpt["params"],
        "prefill_ms": stats["prefill_s"] * 1e3, "decode_ms_per_frame": stats["segments_s"] * 1e3 / steps,
        "dac_host_ms": stats["dac_s"] * 1e3, "generate_audio_s": t_total, "rtf": audio_s / t_total,
        "pcm_rms": rms, "peak_mem_gb": peak_gb,
    }
    print("phase8 hybrid int8 path:", json.dumps(result), flush=True)
    return counts, model, cond, result


# ---------------------------------------------------------------------------
# Phase 9: the profiler, last
# ---------------------------------------------------------------------------

# Device kernels one wrapper call launches, by design (K3: fc1 + gate, then fc2).
DESIGNED_KERNELS = {"int8_matmul": 1, "attn_core_int8": 1, "fused_mlp_int8": 2, "int4_matmul": 1}


def _device_kernels(kernels) -> dict:
    """Device kernels seen by the profiler, by the wrapper that launches them.
    K3's fc2 is K1's body launched as a programmatic dependent (its PDL
    template flag, the last one, set)."""
    def count(pred):
        return sum(e.count for e in kernels if pred(e.key))

    fc2 = count(lambda k: "int8_gemv_cluster<" in k and ", true>(" in k)
    return {
        "int8_matmul": count(lambda k: "int8_gemv_cluster<" in k) - fc2,
        "attn_core_int8": count(lambda k: "attn_cluster" in k),
        "fused_mlp_int8": count(lambda k: "mlp_fc1_gate" in k) + fc2,
        "int4_matmul": count(lambda k: "int4_gemv_cluster" in k),
        "k3_fc1": count(lambda k: "mlp_fc1_gate" in k),
        "k3_fc2": fc2,
    }


def _busy_ms(prof) -> float:
    """Device time covered by at least one kernel: the union of the kernels'
    intervals (K3's fc2, launched early, overlaps its fc1, so the sum of
    kernel times counts that span twice)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy / 1e3


def _phase_profile(label, model, cond, step_ms):
    """Device time of a 32-frame generate under torch.profiler: the busy
    share of the decode step, the kernels that take the device's time, and
    every kernel wrapper's device kernels per call against its design."""
    from torch.profiler import ProfilerActivity, profile

    from zonos_tpu_torch.ops import cuda_attention as A
    from zonos_tpu_torch.ops import cuda_matmul as M
    from zonos_tpu_torch.ops.sampling import SamplingParams

    def run():
        stats = {}
        model.generate(cond, max_new_tokens=32, cfg_scale=2.0, seed=3, sampling_params=SamplingParams(min_p=0.1),
                       forbid_eos=True, kv_int8=True, stats=stats)
        return stats

    wrappers = (M.int8_matmul, A.attn_core_int8, M.fused_mlp_int8, M.fused_mlp_int8_split, M.int4_matmul)
    with torch.no_grad():
        run()
        for w in wrappers:
            w.launches = 0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            stats = run()
    calls = {w.__name__: w.launches for w in wrappers}
    calls["fused_mlp_int8"] += calls.pop("fused_mlp_int8_split")
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if device_ms == 0:
        print(f"phase9 {label} profile: device time not measured (the profiler saw no kernels)", flush=True)
        return
    seen = _device_kernels(kernels)
    designed = {name: DESIGNED_KERNELS[name] * n for name, n in calls.items()}
    per_call = {name: seen[name] for name in designed}
    # K1, K2 and K4 one device kernel per call, K3 two (fc1 + gate, fc2): no other pass
    if per_call != designed or seen["k3_fc1"] != seen["k3_fc2"]:
        _fail(f"phase 9 {label}: device kernels {seen} != designed {designed} for wrapper calls {calls}")
    steps = stats["decode_steps"]
    launches = sum(e.count for e in kernels)
    per_step = device_ms / (steps + 1)  # the prefill counted as one more step
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:10]
    busy_per_step = _busy_ms(prof) / (steps + 1)
    print(f"phase9 {label} profile:", json.dumps({
        "generate_frames": 32, "decode_steps": steps, "device_ms_total": device_ms,
        "kernel_launches": launches, "kernel_launches_per_step": launches / (steps + 1),
        "wrapper_calls": calls, "device_kernels": seen, "device_ms_per_step": per_step,
        "device_busy_ms_per_step": busy_per_step, "busy_share_vs_timed_step": busy_per_step / step_ms,
        "top_kernels": [{"name": e.key[:80], "ms": e.self_device_time_total / 1e3, "count": e.count} for e in top],
    }), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    from zonos_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card_line()
    print(f"card: {card}", flush=True)
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "python": sys.version.split()[0]}), flush=True)

    from zonos_tpu_torch.conditioning import native_g2p

    t = time.perf_counter()
    g2p = threading.Thread(target=native_g2p.available)  # g++ beside the nvcc builds
    g2p.start()
    logs = _build.build_all()
    g2p.join()
    if not native_g2p.available():
        _fail("phase 1: the native G2P library did not build")
    print(f"phase1 build (kernels + G2P library): {time.perf_counter() - t:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    from zonos_tpu_torch.ops.stream_sum import grid_sum_once

    buf = torch.zeros(256 * 2**20, dtype=torch.uint8, device="cuda")  # > the 50 MB L2
    flush = buf.zero_  # written: leaves up to 50 MB of dirty lines (PRs 1-3 timed so)
    read_flush = lambda: grid_sum_once(buf.view(torch.int8).view(-1, 8192), STREAM_BLK)  # noqa: E731  clean lines
    k1 = _k1_cases(gen, flush, read_flush)
    k2 = _k2_cases(gen, flush, read_flush)
    k3 = dict(_k3_cases(gen, flush, read_flush))
    k4 = _k4_cases(gen, flush, read_flush)
    probe_counts, k56 = _k56_cases(gen, flush)
    del buf, flush, read_flush

    for hybrid in (False, True):
        _phase_small_model(bits=8, hybrid=hybrid)
        _phase_small_model(bits=4, hybrid=hybrid)
    _phase_small_checkpoint()
    _phase_small_dac()
    counts, model, cond, result = _phase_main_path(card)
    facade_counts, model4, cond4, result4 = _phase_facade_int4(card)
    _phase_voice_clone(card, model)
    hybrid_counts, model_h, cond_h, result_h = _phase_hybrid(card)
    # last: once torch.profiler has run, host cost per op stays raised in the process
    _phase_profile("int8", model, cond, result["decode_ms_per_frame"])
    _phase_profile("int4", model4, cond4, result4["decode_ms_per_frame"])
    _phase_profile("hybrid int8", model_h, cond_h, result_h["decode_ms_per_frame"])
    del model, model4, model_h

    by_path = {"int8": counts, "int4": facade_counts, "hybrid_int8": hybrid_counts}

    def entry(name, source, replaces, rows, launches):
        main_row = rows[0]
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"], "library_ms": main_row["library_ms"],
            "launches_by_path": {path: c[name] for path, c in by_path.items() if name in c},
        }

    kernels = [
        entry("int8_matmul", "zonos_tpu_torch/csrc/int8_matmul.cu", "zonos_tpu/ops/pallas_matmul.py:54",
              k1, counts["int8_matmul"]),
        entry("attn_core_int8", "zonos_tpu_torch/csrc/attn_core_int8.cu", "zonos_tpu/ops/pallas_attention.py:98",
              k2, counts["attn_core_int8"]),
        entry("fused_mlp_int8", "zonos_tpu_torch/csrc/fused_mlp_int8.cu", "zonos_tpu/ops/pallas_matmul.py:200",
              [k3["K3"], k3["K3 hybrid"]], counts["fused_mlp_int8"]),
        entry("fused_mlp_int8_split", "zonos_tpu_torch/csrc/fused_mlp_int8.cu", "zonos_tpu/ops/pallas_matmul.py:250",
              [k3["K3s"]], counts["fused_mlp_int8_split"]),
        entry("int4_matmul", "zonos_tpu_torch/csrc/int4_matmul.cu", "zonos_tpu/ops/pallas_matmul.py:120",
              k4, facade_counts["int4_matmul"]),
        entry("grid_sum_once", "zonos_tpu_torch/csrc/stream_sum.cu", "tools/bench_stream.py:40",
              [k56["grid_sum_once"]], probe_counts["grid_sum_once"]),
        entry("manual_sum_once", "zonos_tpu_torch/csrc/stream_sum.cu", "tools/bench_stream.py:79",
              [k56["manual_sum_once"]], probe_counts["manual_sum_once"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {_card_line()}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--parts"] and torch.cuda.is_available():
        sys.exit(_kernel_parts())
    sys.exit(main())
