#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (zonos_tpu_torch) on one NVIDIA card, and
its sharded paths on four.

    python3 chip_smoke.py             # one card: phases 0-12, then 14 and 15
    python3 chip_smoke.py --phase13   # four cards: phase 13 only
    python3 chip_smoke.py --phase16   # four cards: phase 16 only (the serving fleet)

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
     256 MB (K5), which leaves clean lines in the L2; each also at one tp =
     2 rank's and one tp = 4 rank's shard shapes; K3, K3s and K4 give
     bit-equal outputs on two calls; K1, K3 and K4 at 16, 24 and 32 rows (the
     8- and 16-slot engines' 16 and 32 rows: one launch) and at 40 (two
     launches of 32 and 8 rows), and K2 over the engine's cache (16 rows of
     3328 slots, a dead span of its own length per row, read through a
     1024-slot attend view) and at head dim 64 (granite-4.0-h-micro's 8 KV
     and 32 query heads, score scale 1/64: the engine's 32 rows through that
     view, and a cache walked in two bulk-copy stages); then K1 and
     K3 called from two host threads at once, 200 calls each at B 2, 16 and 32,
     one thread on a stream of its own: every output bit-equal to the same
     call made alone, launch counts exact;
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
     430 frames (5 s) at cfg 2.0 and min-p 0.1, then the full-size DAC to
     int16 PCM; a 128-frame warm-up run, then the timed run with every
     kernel's launch count set to 0 before it and checked after it;
  6. the facade path on int4 weights: English text and a speaker vector through
     make_cond_dict, prepare_conditioning (cfg 2.0) and generate_audio (the DAC
     of settled spans interleaved with the decode loop) to 430 frames of int16
     PCM; a 128-frame warm-up run, then a run with every launch count set to 0 before it
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
     (K1, K2 and K4 one, K3 two: fc1 + gate, then fc2);
 10. the server, in a process of its own (``--phase10``, so that phase 9's
     profiler raises none of its times): the flagship written as a reference
     checkpoint and named in a configmodel.txt of a temporary working
     directory, ``zonos_tpu_torch.serving.server.main`` started in a thread
     on 127.0.0.1 (start seconds); the GET routes, ping, a /generate with a
     10 s inline speaker wav (its WAV against the file the metadata names),
     the same body again (identical bytes), /stream (time to the first
     chunk), /v1/audio/speech, two concurrent /generate requests bit-equal
     to each served alone; ZONOS_BATCHING=1: eight requests of 1-4 s through
     the continuous engine (four at once, four while the epoch runs: a
     mid-epoch join and a slot recycle required), per-request RTF and audio
     seconds per wall second; greedy codes of a 1-slot engine equal to
     generate's, and those of the 8-slot engine (three at once, one more
     joining mid-epoch) equal to EngineReference's (generate's prefill at 2
     rows, its decode at 16 from the join step); ZONOS_CONTINUOUS=0: four
     requests through the dynamic
     batcher; then the hybrid (as phase 8 makes it) through an engine of 4
     slots. Every path's launch counts of K1-K3 are checked exactly against
     the decode steps and prefills it ran;
 11. training and speculative decode, in a process of its own
     (``--phase11``, after phase 10), f32 with TF32 off: at 2 layers of full
     width, the loss and every leaf's gradient of training.train.loss_fn on
     the card against the CPU (loss within 1e-4 relative, gradient cosine
     >= 0.9999), accum_steps=2 and remat=True against the plain step (1e-5),
     and greedy generate_speculative equal to greedy generate; the LoRA
     fine-tune of the flagship at full depth through
     training.finetune_lora's run() (16 synthetic samples of 192-256
     frames, rank 8, batch 4 x 256 frames, 10 steps: losses finite, the base
     bit-unchanged, every B non-zero), the merged weights written as a
     native checkpoint and read back, their logits against the adapter
     applied unmerged, x.W + scale.(x.A).B (1e-4 relative), then
     cast to bf16, quantized to int8 and driven through generate for 86
     frames on K1-K3 (launch counts exact); speculative decode of that int8
     model at B 1, self-draft, 86 frames (passes, acceptance, the share of
     codes equal to sequential greedy, its first differing frame; the draft
     heads' K1 launches exact: one per pass and one for the prefill); and 3
     AdamW steps of the full train step on the flagship (losses and params
     finite). Seconds per step, targets per second (padding excluded) and
     peak memory for LoRA and the full step; wall ms per output frame of
     speculative decode and of sequential greedy;
 12. data and tensor parallelism on torch.distributed, in a process of its
     own (``--phase12``, after phase 11), ranks spawned on the one card over
     gloo (the backend and world printed on a line of their own): tp = 2 on
     the flagship at full depth, int8 weights and KV, 43 frames at cfg 2.0
     greedy then min-p 0.1, against the one-device int8 generate on the
     same seeded weights run before the ranks start (the tp ranks' codes
     identical in every frame, first-step logits correlation >= 0.999,
     teacher-forced greedy agreement >= 90%, each rank's K1/K2/K3 launch
     counts exact); the same on the hybrid at 2 layers (one Mamba, one
     attention) over 32 frames; dp = 2 on the flagship, 4 rows at one int
     seed, each rank's 2 rows bit-equal to a one-device generate of those
     rows at their global seeds; the sharded train step, dp 2 x tp 2 on 4
     ranks at 2 layers of full width, f32 with TF32 off, transformer and
     hybrid (loss within 1e-4 relative of the one-device loss, each leaf's
     gradient at cosine >= 0.9999, 3 steps at warmup 1 finite and falling);
     ms per frame against one device, and seconds per step;
 13. (not run by default: ``--phase13`` on a machine with four cards, which
     raises with fewer) the sharded paths over nccl, one rank per card: the
     one-device runs on card 0 first (greedy B 1 on the flagship int8, int4
     and the hybrid; greedy and min-p B 4 on int8; phase 11's 4 x 256-frame
     batch), then 4 ranks spawned over nccl, each card's name and power limit
     printed: tp 4 on the flagship int8 with int8 KV (86 frames greedy, then
     min-p 0.1: first-step logits correlation >= 0.999, teacher-forced
     agreement >= 90%, the 4 ranks' codes identical, K1/K2/K3 launches and
     all-reduces per step exact: 49 of each K1 and collective), on the
     flagship int4 (K4 at the tp 4 shapes) and on the full-depth hybrid int8
     (agreement >= 90%, or within 2 points of the one-device floor where that
     is lower: the same model's B 2 run of one row against its B 1 run);
     dp 4 (B 4, a seed per row: each rank's row bit-equal to a one-device B 1
     run of it); dp 2 x tp 2 at B 4 (agreement >= 90% against the one-device
     B 4 run, the tp ranks of each dp index identical); the sharded train
     step at full depth, f32 with TF32 off, on dp 2 x tp 2 and dp 1 x tp 4
     (first loss within 1e-5 relative of one device's, gradient cosine >=
     0.99999, 3 steps falling; seconds per step, targets per second, peak GB
     per card); ms per frame against one device; last, nccl's device time
     per step from a profile of rank 0;
 14. the repository's commands (zonos_tpu_torch.tools), in a process of its
     own (``--phase14``, after phase 12): make_g2p_golden --diff (0 changed
     entries over the 199 entries of 109 codes); e2e_demo on the flagship
     (seeded, int8 weights and KV, through serving.model_manager and
     pipeline.tts) in a temporary working directory: three 44.1 kHz wavs of
     finite PCM equal to what tts returned, long_cold equal to long_warm
     sample for sample, K1-K3 launches exact over the three requests, each
     run's RTF and ms per frame; the seeded bf16 flagship saved as a native
     checkpoint, exported by export_checkpoint, checked by
     validate_checkpoint (load PASS, every other row SKIP with its reason,
     exit 0) and read back by from_local (every param bit-equal, 32 greedy
     int8 frames equal to the source's, launches exact), sizes and seconds;
     profile_components at 86 frames;
 15. the benchmark (zonos_tpu_torch.tools.bench), in a process of its own
     (``--phase15``, after phase 14): ``bench.main(["--device", "cuda"])`` at
     full width and depth with its module constants cut (BENCH_CUTS:
     requests of 1 s, one timed run per leg, 6 sustained engine requests of
     1 s), each leg's launch counts set to 0 just before it and read just
     after it: the JSON line's keys (bench.py's and the card's name and
     power limit), every number finite and > 0, K1-K3 launches exact on the
     sequential, pipelined, batch 8, engine and hybrid legs (from their
     decode steps and prefills) and all three launched in the TTFA leg,
     every engine request's PCM finite and non-empty.
 16. (not run by default: ``--phase16`` on a machine with four cards, which
     raises with fewer) the serving fleet of docs/DEPLOYMENT.md. On card 0,
     in this process, the flagship (seeded, int8) at 32 decode rows: a
     continuous engine of 16 slots (16 requests of 1-2 s at once and 2 more
     that join mid-epoch as slots free, ``JoinTap``) beside one of 8 slots on
     the same 18 requests (ms per step, audio s per wall s), the 16-slot
     engine's greedy codes against EngineReference (its decode at 32 rows),
     the dynamic batcher at max_batch 16 (one batch of 16 in bf16 KV: no
     K2), K1-K3 launches exact on each. Then, in a temporary working
     directory holding the flagship as a reference checkpoint and a complete
     configmodel.txt, four ``python -m zonos_tpu_torch.serving.server
     --warmup`` processes, backend i with CUDA_VISIBLE_DEVICES=i,
     ZONOS_BATCHING=1 and ZONOS_MAX_BATCH=16 (start s each; nvidia-smi must
     list them on four cards), and ``python -m
     zonos_tpu_torch.serving.router`` over them. Through the router: /health
     and /router_stats, POST /speakers and /lexicon reaching 4 backends; one
     fixed-seed request (an inline voice) on each backend in turn,
     bit-equal; 64 requests of 1-4 s naming the uploaded voice from 64
     threads (every answer 200 and non-empty, each backend serving its share
     by its /metrics; audio s per wall s beside 16 sent to backend 0 alone);
     /stream through the router against direct (time to the first bytes,
     bytes equal); an 880-character text (3 chunks) to /generate and /stream
     through the router and direct at once (bit-equal, at least the gaps
     long); the router's /metrics equal to ``aggregate_metrics`` of the four
     pages; backend 3 SIGKILLed while it holds requests of a burst of 32
     (only its requests fail, with the router's 502 naming it; it is
     quarantined); then shutdown (nvidia-smi lists none of the pids) and
     the shared directory (every cached embedding loads, every uploaded wav
     parses, no temporary file left, the wav paths the servers named
     distinct). Every client call has a timeout. With
     ``--phase16 --rehearse-on-one-card`` the four backends share card 0.
With ``--parts``, only the device kernels of one K3, K3s or K4 call at the
main path's shapes, each with its device time under torch.profiler. With
``--pair-streams``, only two flagship requests alone and at once, on the
default stream and on a stream each.
Prints one line per kernel check, a ``{"kernels": [...]}`` line (``launches``
from phase 5, or phase 6 for K4, and ``launches_by_path`` for phases 5, 6, 8,
10 ("server"), 11 ("lora_int8": the merged model's generate,
"speculative"), 12 ("tp2", "tp2_hybrid", "dp2": one rank's counts), 14
("demo", "export_int8") and 15 ("bench": its six legs summed)),
lines naming ``--phase13`` and ``--phase16`` and the cards this run sees,
the card's name and power limit, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import shutil
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
# One rank's shards under tp = 2 (phase 12): the flagship's in_proj (1536 =
# 8 q + 2 k + 2 v heads of 128) and out_proj (rows 1024), the Mamba in_proj
# (8512 / 2); K3 at F 8192 / 2 (the flagship MLP: HYBRID_F's shape) and
# 4096 / 2 (the Mamba layers' MLP); K2 over 2 KV heads and 8 query heads.
TP2_K1 = ((2048, 1536), (1024, 2048), (2048, 4256))
TP2_F = 2048
# One rank's shards under tp = 4 (phase 13): the flagship's in_proj (768 =
# 4 q + 1 k + 1 v heads of 128) and out_proj (rows 512), the Mamba in_proj
# (8512 / 4) and out_proj (rows 4096 / 4); K3 at F 8192 / 4 (TP2_F's shape)
# and 4096 / 4 (the Mamba layers' MLP); K2 over 1 KV head and 4 query heads;
# K4 at the flagship's in_proj, out_proj (4 groups of 128), fc1 and fc2.
TP4_K1 = ((2048, 768), (512, 2048), (2048, 2128), (1024, 2048))
TP4_F = 1024
TP4_K4 = ((2048, 768), (512, 2048), (2048, 4096), (2048, 2048))


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
        "cluster": M.int8_matmul_plan(min(b, M.MAX_ROWS), k, n, sms=M._sm_count(x.device)).cluster,
        "launches_per_call": len(M._row_blocks(b)),
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
    # the decode batch, the 8-slot engine's 16 rows, 24, the 16-slot engine's
    # 32 (one launch) and 40 (two launches: 32 rows, then 8)
    for b in (2, 16, 24, 32, 40):
        # in_proj, out_proj, and the int8 heads in the port's layout (rows padded to 16 bytes)
        for k, n in ((2048, 3072), (2048, 2048), (2048, 9225)):
            rows.append(_k1_case(M, gen, flush, read_flush, b, k, n, pad_rows16, quantize_int8))
    # the hybrid's Mamba in_proj (N 8512: 33 tiles of 256 and a 64-column tail) and out_proj
    for k, n in HYBRID_K1:
        rows.append(_k1_case(M, gen, flush, read_flush, 2, k, n, pad_rows16, quantize_int8, "hybrid "))
    for k, n in TP2_K1:
        rows.append(_k1_case(M, gen, flush, read_flush, 2, k, n, pad_rows16, quantize_int8, "tp2 "))
    for k, n in TP4_K1:
        rows.append(_k1_case(M, gen, flush, read_flush, 2, k, n, pad_rows16, quantize_int8, "tp4 "))
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

    rows = []
    # the main path's cache (1152 slots, timed), a cache long enough that each
    # rank walks its share in two bulk-copy stages (checked only), and the
    # continuous engine's: 16 rows of a 3328-slot cache, a dead span after the
    # 256-slot prefill with its own length per row, read through the
    # 1024-slot view of an attend rung (timed)
    engine_gap = [int(v) for v in np.random.default_rng(7).integers(0, 700, 16)]
    # (and a tp = 2 rank's 2 KV heads and 8 query heads, and a tp = 4 rank's
    # 1 KV head and 4 query heads, over the main path's cache); then head dim
    # 64 at granite-4.0-h-micro's 8 KV and 32 query heads and its score scale
    # 1/64: the engine's 32 rows through the same view (timed) and the long
    # cache's two stages (checked only)
    granite_gap = [int(v) for v in np.random.default_rng(9).integers(0, 700, 32)]
    for case, b, s, view, wi, gap_start, gap, hkv, hq, dh, scale in (
            ("mid-cache", 2, 1152, None, 700, 0, None, 4, 16, 128, None),
            ("gap", 2, 1152, None, 900, 128, [40, 0], 4, 16, 128, None),
            ("long-cache", 2, 8192, None, 8000, 0, None, 4, 16, 128, None),
            ("engine B=16 S=3328 attend 1024", 16, 3328, 1024, 1000, 256, engine_gap, 4, 16, 128, None),
            ("tp2 Hkv 2 Hq 8", 2, 1152, None, 700, 0, None, 2, 8, 128, None),
            ("tp4 Hkv 1 Hq 4", 2, 1152, None, 700, 0, None, 1, 4, 128, None),
            ("granite Dh 64 engine B=32 S=3328 attend 1024", 32, 3328, 1024, 1000, 256, granite_gap, 8, 32, 64,
             1 / 64),
            ("granite Dh 64 long-cache", 2, 8192, None, 8000, 0, None, 8, 32, 64, 1 / 64)):
        q = torch.randn((b, 1, hq, dh), generator=gen, device="cuda").to(torch.bfloat16)
        kq, ks = _kv_quantize(torch.randn((b, s, hkv, dh), generator=gen, device="cuda") * 2.0)
        vq, vs = _kv_quantize(torch.randn((b, s, hkv, dh), generator=gen, device="cuda"))
        kq, vq = kq.transpose(1, 2).contiguous(), vq.transpose(1, 2).contiguous()
        ks, vs = ks.transpose(1, 2).contiguous(), vs.transpose(1, 2).contiguous()
        if view is not None:  # the segment's view of the cache: cut along S, strides kept
            kq, vq, ks, vs = kq[:, :, :view], vq[:, :, :view], ks[:, :, :view], vs[:, :, :view]
            s = view
        pad_host = [3, 17] if b == 2 else [int(v) for v in np.random.default_rng(8).integers(0, 200, b)]
        pad = torch.tensor(pad_host, dtype=torch.int32, device="cuda")
        wi_t = torch.tensor([wi], dtype=torch.int32, device="cuda")
        gap_len = None if gap is None else torch.tensor(gap, dtype=torch.int32, device="cuda")
        args = (q, kq, ks, vq, vs, wi_t, pad, gap_start, gap_len, scale)
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
        lib = lambda: F.scaled_dot_product_attention(qt, kd, vd, attn_mask=mask, enable_gqa=True, scale=scale)  # noqa: E731
        n_valid = [
            sum(1 for j in range(s) if pad_host[i] <= j <= wi and not (gap is not None and gap_start <= j < gap_start + gap[i]))
            for i in range(b)
        ]
        nbytes = sum(hkv * n * (2 * dh + 2 * 4) for n in n_valid) + 2 * b * hq * dh * 2
        ops = sum(hq * n * dh * 4 for n in n_valid)
        kernel = lambda: A.attn_core_int8(*args)  # noqa: E731
        plan = A.attn_plan(s, hq // hkv, dh)
        row = {"case": case, "max_abs_err": err, "corr": corr, "cluster": plan.cluster,
               "stages": -(-plan.share_cap // plan.stage)}
        if "long-cache" not in case:
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
    # the flagship MLP (K3 and K3s), the hybrid's Mamba-layer MLP (K3; a tp = 2
    # rank's flagship MLP too), the flagship MLP at the 8-slot engine's 16
    # rows (K3), at 24, at the 16-slot engine's 32 (K3 and K3s) and at 40 (two
    # fc1 + fc2 pairs), a tp = 2 rank's Mamba-layer MLP (a tp = 4 rank's
    # flagship MLP too), and a tp = 4 rank's Mamba-layer MLP
    for b, d, f, names in ((2, 2048, 8192, ("K3", "K3s")), (2, 2048, HYBRID_F, ("K3 hybrid",)),
                           (16, 2048, 8192, ("K3 B16",)), (24, 2048, 8192, ("K3 B24",)),
                           (32, 2048, 8192, ("K3 B32", "K3s B32")), (40, 2048, 8192, ("K3 B40",)),
                           (32, 2048, HYBRID_F, ("K3 hybrid B32",)), (2, 2048, TP2_F, ("K3 tp2",)),
                           (2, 2048, TP4_F, ("K3 tp4",))):
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
            "fc1_fc2_pairs_per_call": len(M._row_blocks(b)),
            "ms": _time_ms(fn, flush), "plain_ms": _time_ms(plain, flush),
            "library_ms": _time_ms(library, flush),
            "ms_read_flush": _time_ms(fn, read_flush), "library_ms_read_flush": _time_ms(library, read_flush),
        }
        row["bound_ms"], row["bound_by"] = _bound_ms(nbytes, ops)
        rows.append((name, row))
        print(name.split()[0], json.dumps(row), flush=True)
    return rows


def _two_thread_check(gen, calls: int = 200):
    """K1 (2048 -> 3072) and K3 (D 2048, F 8192) from two host threads at
    once, the way the server's request threads call them: each thread makes
    ``calls`` calls of each at B 2, 16 and 32 on its own inputs and weights,
    one thread on the default stream and the other on a stream of its own.
    Every output must be bit-equal to the same call made alone, and the
    launch counts exact. The wrappers enter the kernel libraries through
    ctypes, which releases the GIL: this holds K3's h scratch (kept per
    stream, fc1 + fc2 issued under a lock), the tensor-map cache and the
    attribute flags (a mutex in each library) and the counters (a lock)."""
    from zonos_tpu_torch.ops import cuda_matmul as M
    from zonos_tpu_torch.ops.quant import quantize_int8

    d, n, f = 2048, 3072, 8192
    work = []
    for _t in range(2):
        w1 = quantize_int8(torch.randn((d, n), generator=gen, device="cuda") / d ** 0.5)
        m1 = quantize_int8(torch.randn((d, 2 * f), generator=gen, device="cuda") / d ** 0.5)
        m2 = quantize_int8(torch.randn((f, d), generator=gen, device="cuda") / f ** 0.5)
        xs = {b: torch.randn((b, d), generator=gen, device="cuda").to(torch.bfloat16) for b in (2, 16, 32)}
        calls_t = []
        for b, x in xs.items():
            calls_t.append((f"K1 B={b}", lambda x=x, w=w1: M.int8_matmul(x, w["q"], w["s"])))
            calls_t.append((f"K3 B={b}", lambda x=x, a=m1, c=m2: M.fused_mlp_int8(x, a["q"], a["s"], c["q"], c["s"])))
        work.append(calls_t)
    alone = [[fn() for _name, fn in calls_t] for calls_t in work]
    torch.cuda.synchronize()
    M.int8_matmul.launches = M.fused_mlp_int8.launches = 0
    outs = [[], []]
    errors = []
    side = torch.cuda.Stream()

    def run(t):
        try:
            with torch.cuda.stream(side if t else torch.cuda.default_stream()):
                for _ in range(calls):
                    outs[t].append([fn() for _name, fn in work[t]])
                torch.cuda.current_stream().synchronize()
        except Exception as e:  # reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=run, args=(t,)) for t in range(2)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if errors:
        _fail(f"phase 2 two threads: {errors}")
    counts = {"int8_matmul": M.int8_matmul.launches, "fused_mlp_int8": M.fused_mlp_int8.launches}
    expected = {"int8_matmul": 2 * calls * 3, "fused_mlp_int8": 2 * calls * 3}
    differ = {}
    for t in range(2):
        for i, (name, _fn) in enumerate(work[t]):
            bad = sum(not torch.equal(o[i], alone[t][i]) for o in outs[t])
            if bad:
                differ[f"thread {t} {name}"] = bad
    row = {"calls_per_thread_and_case": calls, "launches": counts, "expected": expected,
           "outputs_differing_from_the_call_alone": differ, "wall_s": wall}
    print("phase2 two threads:", json.dumps(row), flush=True)
    if counts != expected or differ:
        _fail(f"phase 2 two threads: launches {counts} (expected {expected}), differing outputs {differ}")


def _k4_cases(gen, flush, read_flush):
    from zonos_tpu_torch.ops import cuda_matmul as M
    from zonos_tpu_torch.ops.quant import quantize_int4

    rows = []
    # in_proj, out_proj, fc1 and fc2 of a flagship layer at the decode batch,
    # in_proj at 16 and 24 rows, the four at 32 (one launch), in_proj at 40
    # (two launches), then the hybrid's Mamba in_proj, out_proj (and fc2) and
    # its Mamba-layer fc1, and a tp = 4 rank's shards of the flagship layer
    shapes = (("", 2, 2048, 3072), ("", 2, 2048, 2048), ("", 2, 2048, 16384), ("", 2, 8192, 2048),
              ("", 16, 2048, 3072), ("", 24, 2048, 3072),
              *(("", 32, k, n) for k, n in ((2048, 3072), (2048, 2048), (2048, 16384), (8192, 2048))),
              ("", 40, 2048, 3072), ("hybrid ", 32, 2048, 8512),
              *(("hybrid ", 2, k, n) for k, n in HYBRID_K4), *(("tp4 ", 2, k, n) for k, n in TP4_K4))
    for tag, b, k, n in shapes:
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
            "case": f"{tag}B={b} {k}->{n}", "max_abs_err": err.max().item(),
            "cluster": M.int4_matmul_plan(min(b, M.MAX_ROWS), k, n, 128, sms=M._sm_count(x.device)).cluster,
            "launches_per_call": len(M._row_blocks(b)),
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


def _pair_streams() -> int:
    """``--pair-streams``: two int8 requests of the flagship (seed 0) through
    ``generate_audio``, each alone, then both at once from two threads, on
    the default stream and each on a stream of its own: seconds, and whether
    each PCM is bit-equal to its run alone. The measurement behind the
    server's limit of one single request at a time."""
    from zonos_tpu_torch.conditioning.cond_dict import make_cond_dict
    from zonos_tpu_torch.config import zonos_v01_transformer_config
    from zonos_tpu_torch.models.zonos import Zonos
    from zonos_tpu_torch.ops import _build

    _build.build_all()
    model = Zonos.from_config(zonos_v01_transformer_config(), seed=0, dtype=torch.bfloat16, device="cuda").quantize()
    conds = [model.prepare_conditioning(make_cond_dict(text=t, speaker=np.zeros((1, 1, 128), np.float32)))
             for t in ("The inn is warm and the ale is cold.", "Who goes there, stranger of the north?")]

    def one(i, stream=None):
        t = time.perf_counter()
        with torch.cuda.stream(stream or torch.cuda.current_stream()), torch.no_grad():
            if stream is not None:
                stream.wait_stream(torch.cuda.default_stream())
            pcm, _lengths = model.generate_audio(conds[i], max_new_tokens=172, seed=11 + i, pcm_int16=True)
            pcm = np.asarray(pcm.cpu() if torch.is_tensor(pcm) else pcm)
        return pcm, time.perf_counter() - t

    one(0), one(1)  # warm-up
    alone = [one(0), one(1)]
    out = {"card": _card_line(), "alone_s": [a[1] for a in alone]}
    for label, streams in (("default_stream", [None, None]), ("own_streams", [torch.cuda.Stream(), torch.cuda.Stream()])):
        t = time.perf_counter()
        both = _parallel(one, [(i, streams[i]) for i in range(2)])
        out[label] = {"wall_s": time.perf_counter() - t, "each_s": [b[1] for b in both],
                      "bit_equal": [bool(np.array_equal(both[i][0], alone[i][0])) for i in range(2)]}
    print("pair streams:", json.dumps(out), flush=True)
    return 0


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
    frames = 430  # 5 s of audio

    def run(seed, n=frames):
        stats = {}
        t = time.perf_counter()
        codes = model.generate(cond, max_new_tokens=n, cfg_scale=2.0, seed=seed,
                               sampling_params=SamplingParams(min_p=0.1), forbid_eos=True,
                               kv_int8=True, stats=stats)
        t_gen = time.perf_counter() - t
        t = time.perf_counter()
        pcm = ae.decode_device(codes, to_int16=True).cpu().numpy()
        return codes, pcm, stats, t_gen, time.perf_counter() - t

    with torch.no_grad():
        run(1, n=128)  # warm-up, short: kernel libraries loaded; then the DAC at the timed shape
        ae.decode_device(np.zeros((1, cfg.codebook_dimension, frames), np.int32), to_int16=True).cpu()
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

    def run(seed, sampling, frames=FACADE_FRAMES):
        stats = {}
        t = time.perf_counter()
        wav, lengths = model.generate_audio(cond, max_new_tokens=frames, cfg_scale=2.0,
                                            sampling_params=sampling, seed=seed, forbid_eos=True,
                                            pcm_int16=True, stats=stats)
        return wav, lengths, stats, time.perf_counter() - t

    kernels = (M.int4_matmul, M.int8_matmul, A.attn_core_int8, M.fused_mlp_int8, M.fused_mlp_int8_split)
    with torch.no_grad():
        cond, _ = conditioning()
        run(1, SamplingParams(min_p=0.1), frames=128)  # warm-up, short
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
# Phase 10: the server, the continuous engine and the dynamic batcher
# ---------------------------------------------------------------------------

# Token budgets follow the text length (pipeline.prepare_generation_params):
# max(86, 2 + ceil(6.5 * characters)) frames, so 13 characters make 1 s of
# audio, 26 make 2 s, 39 make 3 s and 52 make 4 s.
SERVER_TEXT = "Good evening, my friend."  # 24 characters: 158 frames
ENGINE_WAVE1 = ["Hello there.", "Stay awhile.",
                "The guards at the gate will not let you pass tonight.",
                "Bring me three wolf pelts and I will pay you in gold."]
ENGINE_WAVE2 = ["Who goes there", "The inn is warm and the ale is cold",
                "Snow falls on the mountain pass, so travel at dawn.", "Farewell, friend."]


def _http(port: int, path: str, body=None, timeout: float = 900.0):
    """(status, headers, bytes) of one request to the local server; any
    status but 200 fails the run."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        _fail(f"phase 10: {path} answered {e.code}: {e.read()[:300]!r}")


def _wav(data: bytes) -> tuple[int, np.ndarray]:
    import io
    import wave

    with wave.open(io.BytesIO(data)) as w:
        if w.getnchannels() != 1 or w.getsampwidth() != 2:
            _fail(f"phase 10: a WAV of {w.getnchannels()} channels, {w.getsampwidth()} bytes per sample")
        return w.getframerate(), np.frombuffer(w.readframes(w.getnframes()), "<i2")


def _parallel(fn, args_list, timeout: float | None = None, phase: str = "phase 10") -> list:
    """fn(*args) for each args on a thread of its own, all started at once;
    results in order. An exception on any thread fails the run, and so
    does, with a ``timeout``, a thread still running after it."""
    out, errors = [None] * len(args_list), []

    def run(i, args):
        try:
            out[i] = fn(*args)
        except BaseException as e:  # noqa: BLE001  reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=run, args=(i, a), daemon=timeout is not None) for i, a in enumerate(args_list)]
    for t in threads:
        t.start()
    end = None if timeout is None else time.perf_counter() + timeout
    for t in threads:
        t.join(timeout=None if end is None else max(0.0, end - time.perf_counter()))
    if any(t.is_alive() for t in threads):
        _fail(f"{phase}: {sum(t.is_alive() for t in threads)} calls still running after {timeout:.0f} s")
    if errors:
        _fail(f"{phase}: {errors}")
    return out


def _greedy_parity(model, eng, max_new_tokens: int | None = None, label: str = "phase10") -> dict:
    """Greedy codes of the continuous engine ``eng`` (2·slots rows) on
    ``model``'s device; every gate is exact:
    - a 1-slot engine (2 rows) per request against generate alone (2 rows),
      at the engine's prefill bucket and cache length (another bucket moves
      greedy tokens, in JAX as in the port);
    - ``eng``: three requests at once, and then, in a fresh engine of its
      shapes, the first again joining mid-epoch behind a longer request,
      each against EngineReference from its recorded join step.
    Reported beside them: the codes' first differing frame against generate
    at 2 rows and at the engine's rows, and the share of generate's 2-row picks that the
    engine's arithmetic makes too (teacher forcing): K1's and K3's 2-row
    plans, and the int8 q of a 16-row prefill, move near-tied picks of
    random weights. ``max_new_tokens`` caps the requests (a short run on the CPU);
    ``label`` names the phase in what it prints."""
    tag = label.replace("phase", "phase ")
    from zonos_tpu_torch.ops.sampling import SamplingParams
    from zonos_tpu_torch.runtime.generate import generate
    from zonos_tpu_torch.serving.batcher import DynamicBatcher, TTSRequest
    from zonos_tpu_torch.serving.continuous import ContinuousEngine, _SingleView
    from zonos_tpu_torch.serving.pipeline import prepare_generation_params

    greedy = SamplingParams(temperature=0.0)
    picks = [ENGINE_WAVE1[0], ENGINE_WAVE2[3], ENGINE_WAVE2[0]]

    def greedy_request(i, text, seed=None):
        n = prepare_generation_params(text, randomize_seed=False).max_new_tokens
        return TTSRequest(text=text, seed=300 + i if seed is None else seed, sampling=greedy,
                          max_new_tokens=min(n, max_new_tokens or n))

    def reference(req, rows):
        cond = model.prepare_conditioning(DynamicBatcher._batched_cond_dict(_SingleView(model), [req]),
                                          cfg_scale=req.cfg_scale)
        b = rows // 2
        cond = torch.cat([cond[:1].expand(b, -1, -1), cond[1:].expand(b, -1, -1)])
        return generate(model.params, model.config, cond, max_new_tokens=req.max_new_tokens,
                        cfg_scale=req.cfg_scale, batch_size=b, sampling_params=greedy, seed=[req.seed] * b,
                        prefill_bucket=eng.prefill_len, audio_bucket=eng.delayed_len, dtype=model.dtype,
                        kv_int8=True, device=model.device)[0]

    def first_diff(ref, mine):
        n = min(ref.shape[-1], mine.shape[-1])
        diff = np.nonzero((ref[:, :n] != mine[:, :n]).any(axis=0))[0]
        return int(diff[0]) if diff.size else (None if ref.shape == mine.shape else n)

    def engine_like(slots):  # an engine of eng's shapes
        return ContinuousEngine(model, slots=slots, prefill_len=eng.prefill_len,
                                max_new_cap=eng.delayed_len - model.config.codebook_dimension,
                                segment_frames=eng.segment_frames, first_chunk_frames=eng.first_chunk_frames)

    with torch.no_grad():
        refs2 = [reference(greedy_request(i, t), 2) for i, t in enumerate(picks)]
        gate = []
        for i, text in enumerate(picks):
            req = greedy_request(i, text)
            one = engine_like(1)
            tap = CodeTap(one)
            try:
                one.submit(req)
            finally:
                one.close()
            gate.append({"frames": int(refs2[i].shape[-1]), "engine_frames": int(tap.of(req).shape[-1]),
                         "first_differing_frame": first_diff(refs2[i], tap.of(req))})
        print(f"{label} greedy codes, 1-slot engine vs generate (gate):", json.dumps(gate), flush=True)
        if any(p["first_differing_frame"] is not None for p in gate):
            _fail(f"{tag}: greedy codes of a 1-slot engine differ from generate's: {gate}")

        # the three at once in eng; then, in a fresh engine of eng's shapes,
        # the first again joining behind a longer request
        reqs = [greedy_request(i, t) for i, t in enumerate(picks)]
        filler = TTSRequest(text=ENGINE_WAVE2[1], seed=399, sampling=greedy,  # uncut: it outlives the joiner
                            max_new_tokens=prepare_generation_params(ENGINE_WAVE2[1], randomize_seed=False).max_new_tokens)
        late = greedy_request(0, picks[0], seed=303)  # greedy: its codes are the first's
        rolled = eng.stats["rolled_steps"]
        mid = engine_like(eng.slots)
        taps = [CodeTap(eng)] * 3 + [CodeTap(mid)]
        try:
            with JoinTap() as joins:
                _parallel(eng.submit, [(r,) for r in reqs])

                def join_late():  # once the filler's first segment has run
                    t = time.perf_counter()
                    while not mid.stats["steps"] and time.perf_counter() - t < 120:
                        time.sleep(0.01)
                    mid.submit(late)

                _parallel(lambda f: f(), [(lambda: mid.submit(filler),), (join_late,)])
        finally:
            mid.close()
        if eng.stats["rolled_steps"] != rolled or mid.stats["rolled_steps"]:
            _fail(f"{tag}: a KV roll during the greedy requests: EngineReference assumes none")
        ref = EngineReference(model, eng)
        wide = []
        for i, r in enumerate(reqs + [late]):
            j, got = joins.of(r, model.device), taps[i].of(r)
            wide.append({"join_step": j, "frames": int(got.shape[-1]),
                         "vs_reference": first_diff(ref.codes(r, j), got),
                         "vs_generate_2_rows": first_diff(refs2[i if i < 3 else 0], got),
                         "vs_generate_engine_rows": first_diff(reference(r, 2 * eng.slots), got) if i < 3 else None,
                         "generate_2_rows_forced": ref.forced(r, refs2[i], j) if i < 3 else None})
    print(f"{label} greedy codes, {eng.slots}-slot engine vs EngineReference (gate), vs generate at 2 and at "
          f"{2 * eng.slots} rows:", json.dumps(wide), flush=True)
    if any(p["vs_reference"] is not None for p in wide) or not wide[-1]["join_step"] > 0:
        _fail(f"{tag}: greedy codes of the {eng.slots}-slot engine differ from EngineReference's, "
              f"or the late request did not join mid-epoch: {wide}")
    return {"one_slot_engine": gate, "eight_slot_engine": wide}


class EngineReference:
    """A greedy request's codes as the continuous engine computes them, made
    with generate's own prefill and decode functions: the prefill at the
    engine's 2 rows (the engine prefills each joiner alone), then the decode
    at its 2·slots rows (the request's rows repeated into every slot), at the
    engine's prefill bucket, code buffer and cache length, from the batch
    step the request joined at (``JoinTap``; no KV roll in between). A
    generate call at 16 rows is not this: its prefill quantizes q to int8
    at 16 rows (as JAX's does, ``ops/attention.gqa_attention_quantized``),
    and one at 2 rows decodes on K1's and K3's 2-row plans, whose f32 sums
    group differently. ``forced`` runs given codes through the same
    arithmetic (teacher forcing) and counts the (step, codebook) pairs where
    the given token is the reference's greedy pick."""

    def __init__(self, model, eng):
        self.model, self.eng = model, eng

    def _start(self, req, join_step: int):
        from zonos_tpu_torch.models.transformer import KVCache
        from zonos_tpu_torch.runtime.generate import prepare_request
        from zonos_tpu_torch.runtime.streaming import build_prefill_fn
        from zonos_tpu_torch.serving.batcher import DynamicBatcher
        from zonos_tpu_torch.serving.continuous import _SingleView

        m, b = self.model, self.eng.slots
        cond = m.prepare_conditioning(DynamicBatcher._batched_cond_dict(_SingleView(m), [req]),
                                      cfg_scale=req.cfg_scale)
        r = prepare_request(m.config, cond, None, req.max_new_tokens, req.cfg_scale, 1, req.sampling, [req.seed],
                            m.dtype, False, True, m.device, self.eng.prefill_len, self.eng.delayed_len)
        if r.statics.cache_len > self.eng.cache_len:
            _fail(f"engine reference: cache {r.statics.cache_len} > the engine's {self.eng.cache_len}")
        c = build_prefill_fn(r.statics)(m.params, r.cond_padded, r.delayed_init, 1, r.pad_amount, req.cfg_scale,
                                        r.generators)
        rows = torch.tensor([0] * b + [1] * b, device=m.device)  # cond rows, then uncond rows
        k = c.cache
        c.cache = KVCache(k=k.k[:, rows].contiguous(), v=k.v[:, rows].contiguous(),
                          k_scale=k.k_scale[:, rows].contiguous(), v_scale=k.v_scale[:, rows].contiguous())
        c.delayed_codes = c.delayed_codes.repeat(b, 1, 1)
        c.stopping, c.remaining_steps = c.stopping.repeat(b), c.remaining_steps.repeat(b)
        c.stop_offset, c.generators = c.stop_offset.repeat(b), c.generators * b
        # a join at batch step j: decode from cache slot P + j, RoPE at the
        # request's own positions, the slots [P, P + j) masked
        c.steps_done = join_step
        gap = torch.full((2 * b,), join_step, dtype=torch.int32, device=m.device)
        return c, dataclasses.replace(r.statics, batch_size=b), r.pad_amount[rows], join_step + r.max_steps, gap

    def codes(self, req, join_step: int = 0) -> np.ndarray:
        """The request's greedy codes [n_q, T], joined at batch step ``join_step``."""
        from zonos_tpu_torch.runtime.generate import postprocess_codes_batched
        from zonos_tpu_torch.runtime.streaming import build_segment_fn

        c, statics, pad, max_steps, gap = self._start(req, join_step)
        c, _status, _codes = build_segment_fn(statics)(self.model.params, c, pad, req.cfg_scale, max_steps=max_steps,
                                                       segment_end=2**30, pos_offset=gap, gap_len=gap)
        stop = c.stop_offset.cpu().numpy()
        out, _lengths = postprocess_codes_batched(c.delayed_codes.cpu().numpy(), np.where(stop >= 0, stop, c.offset),
                                                  self.model.config)
        return out[0]

    def forced(self, req, codes: np.ndarray, join_step: int = 0) -> dict:
        """Teacher forcing of codes [n_q, T]: the prefill's pick, then each
        step's input frame taken from codes; for every (step, codebook)
        whose token is a code (< 1024), is it the reference's greedy pick
        (after the repetition penalty), and if not, how far below the top
        logit it lies."""
        from zonos_tpu_torch.ops.delay_pattern import apply_delay_pattern_np
        from zonos_tpu_torch.ops.sampling import apply_repetition_penalty
        from zonos_tpu_torch.runtime.generate import _context_slice, _decode_logits
        from zonos_tpu_torch.runtime.streaming import _make_bias

        m, sp = self.model, req.sampling
        cfg = m.config
        picks = []

        def pick(logits, delayed, o):
            ctx, valid = _context_slice(delayed, o, sp.repetition_penalty_window)
            picks.append(apply_repetition_penalty(logits, ctx, sp.repetition_penalty, sp.repetition_penalty_window,
                                                  valid_len=valid)[0].float().cpu())

        # the prefill's pick: the same prefill again, its last position's logits
        from zonos_tpu_torch.runtime import streaming
        sample = streaming.sample_from_logits
        first = []
        streaming.sample_from_logits = lambda logits, *a, **k: (first.append(logits), sample(logits, *a, **k))[1]
        try:
            c, statics, pad, _max_steps, gap = self._start(req, join_step)
        finally:
            streaming.sample_from_logits = sample
        n_q, t = codes.shape
        fd = torch.as_tensor(apply_delay_pattern_np(codes[None].astype(np.int32), cfg.masked_token_id)[0],
                             device=m.device)  # delayed index o holds codebook k's frame o - 1 - k
        d = c.delayed_codes
        picks.append(first[0][0].float().cpu())  # the prefill samples with no bias and no penalty
        d[:, :, 1] = fd[:, 1]
        bias = _make_bias(statics, m.device)
        for o in range(2, t + 1):
            logits, c.cache = _decode_logits(m.params, statics, d[:, :, o - 1:o], c.cache,
                                             statics.prefill_len + join_step + o - 2, pad, req.cfg_scale,
                                             pos_offset=gap, gap_len=gap)
            pick(logits + bias, d, o)
            d[:, :, o] = fd[:, o]
        agree = compared = 0
        worst = 0.0
        for j, x in enumerate(picks):  # pick j chose delayed index j + 1
            for k in range(n_q):
                f = j - k
                if 0 <= f < t and codes[k, f] < 1024:
                    compared += 1
                    top = int(torch.argmax(x[k]))
                    agree += top == int(codes[k, f])
                    worst = max(worst, float(x[k, top] - x[k, int(codes[k, f])]))
        return {"compared": compared, "agree": agree, "worst_gap": worst}


class JoinTap:
    """Records the batch step at which each request joins a continuous
    engine, keyed by its row generator's initial seed (``of``), by wrapping
    the join of every epoch that starts while the tap is open."""

    def __init__(self):
        self.steps: dict[int, int] = {}

    def __enter__(self):
        from zonos_tpu_torch.serving import continuous

        self._module, self._fns = continuous, continuous.compiled_continuous_fns

        def fns(statics):
            start, segment, prefill_b1, join, kill = self._fns(statics)

            def join_recorded(bc, c1, *args, **kw):
                self.steps[c1.generators[0].initial_seed()] = bc.steps_done
                return join(bc, c1, *args, **kw)

            return start, segment, prefill_b1, join_recorded, kill

        continuous.compiled_continuous_fns = fns
        return self

    def __exit__(self, *exc):
        self._module.compiled_continuous_fns = self._fns

    def of(self, req, device) -> int:
        from zonos_tpu_torch.runtime.generate import row_generators

        return self.steps[row_generators(int(req.seed) & 0x7FFFFFFF, 1, device)[0].initial_seed()]


class CodeTap:
    """Records, per request, the sanitized codes each chunk the engine ships
    was decoded from, in ship order: the request's codes as the engine made
    them. It wraps the engine's two PCM functions and its ship queue."""

    def __init__(self, eng):
        self.codes: dict[int, list] = {}
        self._pieces = {}
        quantum, solo, put = eng._quantum_pcm, eng._solo_pcm, eng._ship_q.put
        w, f = eng._quantum_frames, eng._solo_frames

        def tap_quantum(device_codes, lo0, total, starts, bnds):
            pcm = quantum(device_codes, lo0, total, starts, bnds)
            self._pieces[id(pcm)] = device_codes[:, :, int(lo0):int(lo0) + w].cpu().numpy()
            return pcm

        def tap_solo(device_codes, slot, lo0, total, bnd):
            pcm = solo(device_codes, slot, lo0, total, bnd)
            self._pieces[id(pcm)] = device_codes[int(slot), :, int(lo0):int(lo0) + f].cpu().numpy()
            return pcm

        def tap_put(item, *a, **k):
            if item is not None and item[0] == "pcm":
                _, pcm, rows, lo0, _sr = item
                piece = self._pieces.pop(id(pcm))
                for req, slot, lo, hi in rows:
                    self.codes.setdefault(id(req), []).append(piece[slot, :, lo - lo0:hi - lo0])
            elif item is not None and item[0] == "solo":
                _, pcm, req, lo0, base, hi, _sr = item
                self.codes.setdefault(id(req), []).append(self._pieces.pop(id(pcm))[:, base - lo0:hi - lo0])
            return put(item, *a, **k)

        eng._quantum_pcm, eng._solo_pcm, eng._ship_q.put = tap_quantum, tap_solo, tap_put

    def of(self, req) -> np.ndarray:
        return np.concatenate(self.codes.get(id(req), []), axis=-1)


def _phase_server(card: str, single_rtf: float, model_h):
    """``python -m zonos_tpu_torch.serving.server`` as users start it, in a
    thread of this process (so the launch counters can be read), on the
    flagship transformer read from a reference checkpoint and quantized to
    int8: the routes, single requests (pipeline.tts), two at once, the
    continuous engine (ZONOS_BATCHING=1) and the dynamic batcher
    (ZONOS_CONTINUOUS=0), each with its launch counts checked exactly; greedy
    codes of the engine against generate; then phase 8's hybrid through an
    engine of 4 slots."""
    import base64
    import http.client
    import socket

    from zonos_tpu_torch.audio.io import write_wav
    from zonos_tpu_torch.config import zonos_v01_transformer_config
    from zonos_tpu_torch.models.zonos import Zonos
    from zonos_tpu_torch.ops import cuda_attention as A
    from zonos_tpu_torch.ops import cuda_matmul as M
    from zonos_tpu_torch.ops.sampling import SamplingParams
    from zonos_tpu_torch.runtime.generate import generate
    from zonos_tpu_torch.serving import model_manager, server
    from zonos_tpu_torch.serving.batcher import DynamicBatcher, TTSRequest
    from zonos_tpu_torch.serving.continuous import ContinuousEngine, _SingleView
    from zonos_tpu_torch.serving.pipeline import prepare_generation_params
    from zonos_tpu_torch.utils.export import save_reference_checkpoint

    kernels = (M.int8_matmul, A.attn_core_int8, M.fused_mlp_int8)
    cfg = zonos_v01_transformer_config()
    L = cfg.backbone.n_layer

    def reset():
        for k in kernels:
            k.launches = 0

    def counts():
        return {k.__name__: k.launches for k in kernels}

    def expected(steps, prefills, layers=L, attn_layers=L):
        # per decode step: in_proj + out_proj of every layer and the heads on
        # K1, every MLP on K3, K2 in the attention layers; per prefill the
        # last position's heads on K1
        return {"int8_matmul": steps * (2 * layers + 1) + prefills, "attn_core_int8": steps * attn_layers,
                "fused_mlp_int8": steps * layers}

    def check(label, got, want):
        print(f"phase10 {label} launches:", json.dumps(got), "expected:", json.dumps(want), flush=True)
        if got != want:
            _fail(f"phase 10 {label}: launch counts {got} != expected {want}")

    total = {k.__name__: 0 for k in kernels}

    def add(c):
        for k, v in c.items():
            total[k] += v

    env_keys = ("ZONOS_BATCHING", "ZONOS_CONTINUOUS", "ZONOS_PLATFORM", "ZONOS_TINY_MODEL")
    saved_env = {k: os.environ.get(k) for k in env_keys}
    cwd = os.getcwd()
    result = {"card": card}
    thread = None
    with tempfile.TemporaryDirectory() as ckpt, tempfile.TemporaryDirectory() as work:
        try:
            seeded = Zonos.from_config(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
            save_reference_checkpoint(ckpt, seeded.params, seeded.config)
            del seeded
            torch.cuda.empty_cache()
            with open(os.path.join(work, "configmodel.txt"), "w") as f:
                f.write(f"PATH_MODEL_TRANSFORMER = {ckpt}\n")
            os.chdir(work)  # configmodel.txt, cache/ and output_temp/ of the server
            for k in env_keys:
                os.environ.pop(k, None)
            with socket.socket() as sk:
                sk.bind(("127.0.0.1", 0))
                port = sk.getsockname()[1]
            model_manager._CURRENT_MODEL = model_manager._CURRENT_NAME = None
            server._SERVER = None
            t0 = time.perf_counter()
            thread = threading.Thread(target=server.main, args=(["--server", "127.0.0.1", "--port", str(port)],),
                                      daemon=True)
            thread.start()
            while server._SERVER is None:
                if not thread.is_alive():
                    _fail("phase 10: the server exited before it listened")
                if time.perf_counter() - t0 > 600:
                    _fail("phase 10: the server did not listen within 600 s")
                time.sleep(0.05)
            _http(port, "/health")
            result["server_start_s"] = time.perf_counter() - t0
            print(f"phase10 server start (checkpoint load, int8 quantize, listen): {result['server_start_s']:.2f} s",
                  flush=True)
            model = model_manager._CURRENT_MODEL
            hop, sr = model.autoencoder.config.hop_length, model.autoencoder.sampling_rate
            steps_log = []
            generate_audio = model.generate_audio

            def recorded(*args, **kw):  # the decode steps of every generate_audio the server runs
                stats = kw.pop("stats", None)
                stats = {} if stats is None else stats
                out = generate_audio(*args, stats=stats, **kw)
                steps_log.append(stats["decode_steps"])
                return out

            model.generate_audio = recorded
            stream_steps = []
            model_stream = model.stream

            def recorded_stream(*args, **kw):  # the decode steps of every stream the server runs
                stats = {}
                yield from model_stream(*args, stats=stats, **kw)
                stream_steps.append(stats["decode_steps"])

            model.stream = recorded_stream

            for path in ("/health", "/models", "/languages", "/conditioners", "/ui_spec", "/metrics"):
                _http(port, path)
            _code, headers, data = _http(port, "/generate", {"text": "ping"})
            rate, pcm = _wav(data)
            if (rate, pcm.size, int(np.abs(pcm).max())) != (44100, 4410, 0):
                _fail(f"phase 10: ping gave {pcm.size} samples at {rate} Hz")

            # single requests through pipeline.tts
            write_wav("speaker.wav", _voice(10.0, 24000, seed=21), 24000)
            with open("speaker.wav", "rb") as f:
                spk_b64 = base64.b64encode(f.read()).decode()
            body = {"text": SERVER_TEXT, "seed": 7, "randomize_seed": False, "speaker_wav_base64": spk_b64}
            reset()
            steps_log.clear()
            t = time.perf_counter()
            _code, headers, first = _http(port, "/generate", body)
            first_s = time.perf_counter() - t
            meta = json.loads(headers["X-Zonos-Meta"])
            rate, pcm = _wav(first)
            _r, on_disk = _wav(open(meta["path"], "rb").read())
            rms = float(np.sqrt(np.mean(pcm.astype(np.float64) ** 2)))
            if rate != 44100 or meta["sample_rate"] != 44100 or pcm.size == 0 or not rms > 0 or on_disk.size != pcm.size:
                _fail(f"phase 10: /generate gave {pcm.size} samples at {rate} Hz (file {on_disk.size}), rms {rms}")
            again = _http(port, "/generate", body)[2]
            if again != first:
                _fail("phase 10: the same /generate body at a fixed seed gave different bytes")
            _code, headers, speech = _http(port, "/v1/audio/speech", {"input": "Speak, friend.", "seed": 3})
            if _wav(speech)[1].size == 0:
                _fail("phase 10: /v1/audio/speech gave no audio")
            bodies = [{"text": "A quiet night in Whiterun.", "seed": 11, "randomize_seed": False},
                      {"text": "The dragon is near, hurry!", "seed": 12, "randomize_seed": False}]
            t = time.perf_counter()
            alone = [_http(port, "/generate", b)[2] for b in bodies]
            alone_s = time.perf_counter() - t
            t = time.perf_counter()
            both = _parallel(lambda b: _http(port, "/generate", b)[2], [(b,) for b in bodies])
            both_s = time.perf_counter() - t
            same = [both[i] == alone[i] for i in range(2)]
            print("phase10 two concurrent /generate bit-equal to each served alone:", same,
                  f"({both_s:.2f} s at once, {alone_s:.2f} s one after the other)", flush=True)
            result.update(pair_at_once_s=both_s, pair_one_after_other_s=alone_s)
            if not all(same):
                _fail(f"phase 10: concurrent requests differ from the same requests served alone: {same}")
            single = counts()
            check("single requests", single, expected(sum(steps_log), len(steps_log)))
            add(single)
            result.update(single_requests=len(steps_log), single_first_request_s=first_s,
                          single_first_request_rtf=meta["rtf"], single_audio_s=pcm.size / 44100)

            # /stream: chunked PCM16, time to the first chunk and to the end
            reset()
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=900)
            t = time.perf_counter()
            conn.request("POST", "/stream", json.dumps({"text": SERVER_TEXT, "seed": 8, "randomize_seed": False}))
            resp = conn.getresponse()
            if resp.status != 200 or resp.getheader("X-PCM-Format") != "s16le-mono":
                _fail(f"phase 10: /stream answered {resp.status}")
            head = resp.read(2)
            ttfa = time.perf_counter() - t
            stream = head + resp.read()
            stream_s = time.perf_counter() - t
            conn.close()
            got = counts()
            if len(stream_steps) != 1:
                _fail(f"phase 10: /stream ran {len(stream_steps)} decodes")
            check("stream", got, expected(stream_steps[0], 1))
            add(got)
            if len(stream) < 2 * hop or len(stream) % 2:
                _fail(f"phase 10: /stream gave {len(stream)} bytes")
            result.update(stream_ttfa_s=ttfa, stream_total_s=stream_s, stream_audio_s=len(stream) / 2 / 44100)
            print("phase10 single requests:", json.dumps(result), flush=True)

            # the continuous engine: four requests at once, four more while the epoch runs
            os.environ["ZONOS_BATCHING"] = "1"
            reset()

            def engine_request(text, seed):
                t = time.perf_counter()
                _c, h, d = _http(port, "/generate", {"text": text, "seed": seed, "randomize_seed": False})
                m = json.loads(h["X-Zonos-Meta"])
                r, p = _wav(d)
                if not m.get("batched") or r != 44100 or p.size == 0:
                    _fail(f"phase 10: engine request {text!r}: {m}, {p.size} samples")
                return {"text_chars": len(text), "audio_s": p.size / r, "rtf": m["rtf"],
                        "wall_s": time.perf_counter() - t, "rms": float(np.sqrt(np.mean(p.astype(np.float64) ** 2)))}

            t = time.perf_counter()
            wave1 = [(text, 100 + i) for i, text in enumerate(ENGINE_WAVE1)]
            out1 = []
            longs = [threading.Thread(target=lambda a=a: out1.append(engine_request(*a))) for a in wave1[2:]]
            for th in longs:
                th.start()
            shorts = _parallel(engine_request, wave1[:2])  # the 1 s requests end first, freeing their slots
            wave2 = _parallel(engine_request, [(text, 200 + i) for i, text in enumerate(ENGINE_WAVE2)])
            for th in longs:
                th.join()
            burst_s = time.perf_counter() - t
            reqs = shorts + out1 + wave2
            if len(reqs) != 8 or not all(r["rms"] > 0 for r in reqs):
                _fail(f"phase 10: engine burst answered {len(reqs)} of 8 requests, or one was silent: {reqs}")
            eng = server._BATCHER
            if not isinstance(eng, ContinuousEngine):
                _fail(f"phase 10: ZONOS_BATCHING=1 served through {type(eng).__name__}")
            stats = dict(eng.stats)
            print("phase10 engine stats:", json.dumps(stats), flush=True)
            if stats["mid_epoch_joins"] < 1 or stats["slot_recycles"] < 1 or stats["requests"] != 8:
                _fail(f"phase 10: no mid-epoch join or slot recycle: {stats}")
            got = counts()
            check("engine", got, expected(stats["steps"], stats["prefills"]))
            add(got)
            audio = sum(r["audio_s"] for r in reqs)
            result["engine"] = {"requests": reqs, "burst_s": burst_s, "audio_s": audio,
                                "audio_s_per_wall_s": audio / burst_s, "phase5_single_request_rtf": single_rtf,
                                "steps": stats["steps"], "slots": eng.slots, "cache_len": eng.cache_len,
                                "ms_per_step": burst_s * 1e3 / max(stats["steps"], 1)}
            print("phase10 engine burst:", json.dumps(result["engine"]), flush=True)

            result["greedy_parity"] = _greedy_parity(model, eng)
            eng.close()
            server._BATCHER = server._BATCHER_MODEL = None

            # the dynamic batcher
            os.environ["ZONOS_CONTINUOUS"] = "0"
            reset()
            steps_log.clear()
            t = time.perf_counter()
            dyn = _parallel(engine_request, [(text, 400 + i) for i, text in enumerate(ENGINE_WAVE2)])
            dyn_s = time.perf_counter() - t
            batcher = server._BATCHER
            if not isinstance(batcher, DynamicBatcher) or batcher.stats["requests"] != 4:
                _fail(f"phase 10: ZONOS_CONTINUOUS=0 served through {type(batcher).__name__}")
            got = counts()
            check("dynamic batcher", got, expected(sum(steps_log), len(steps_log)))
            add(got)
            result["batcher"] = {"stats": dict(batcher.stats), "wall_s": dyn_s,
                                 "audio_s_per_wall_s": sum(r["audio_s"] for r in dyn) / dyn_s, "requests": dyn}
            print("phase10 dynamic batcher:", json.dumps(result["batcher"]), flush=True)
            if batcher.stats["batches"] >= 4:
                _fail(f"phase 10: the dynamic batcher coalesced nothing: {batcher.stats}")
            batcher.close()
            server._BATCHER = server._BATCHER_MODEL = None
        finally:
            if server._SERVER is not None:
                server._SERVER.shutdown()
            if thread is not None:
                thread.join(timeout=60)
            server._SERVER = None
            model_manager._CURRENT_MODEL = model_manager._CURRENT_NAME = None
            os.chdir(cwd)
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    # phase 8's hybrid through an engine of 4 slots
    n_attn = sum(1 for i in range(model_h.config.backbone.n_layer) if i in model_h.config.backbone.attn_layer_idx)
    eng = ContinuousEngine(model_h, slots=4)
    reset()
    try:
        texts = ["Hello there.", "Stay awhile.", "Who goes there", "Good morning."]
        t = time.perf_counter()
        outs = _parallel(lambda text, i: (time.sleep(0.4 * i), eng.submit(TTSRequest(text=text, seed=500 + i,
                                                                                      max_new_tokens=86)))[1],
                         [(text, i) for i, text in enumerate(texts)])
        hybrid_s = time.perf_counter() - t
        stats = dict(eng.stats)
    finally:
        eng.close()
    rms = [float(np.sqrt(np.mean(w.astype(np.float64) ** 2))) for w, _sr in outs]
    if not all(r > 0 for r in rms) or not all(w.size > 0 for w, _sr in outs):
        _fail(f"phase 10 hybrid engine: silent or empty answers, rms {rms}")
    got = counts()
    check("hybrid engine", got, expected(stats["steps"], stats["prefills"], layers=model_h.config.backbone.n_layer,
                                        attn_layers=n_attn))
    result["hybrid_engine"] = {"stats": stats, "wall_s": hybrid_s, "rms": rms,
                               "audio_s_per_wall_s": sum(w.size for w, _ in outs) / 44100 / hybrid_s}
    print("phase10 hybrid engine:", json.dumps(result["hybrid_engine"]), flush=True)
    return total, result


PHASE10_RESULT = "phase10 result:"


def _phase_server_main(single_rtf: float) -> int:
    """``--phase10 <phase 5 RTF>``: phase 10 in a process of its own (started
    by ``_child_phase``), with the hybrid rebuilt as phase 8 made it
    (seed 0, int8). Prints the launch counts as its last line."""
    from zonos_tpu_torch.config import zonos_v01_hybrid_config
    from zonos_tpu_torch.models.zonos import Zonos
    from zonos_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()  # built by the parent: finds every library
    card = _card_line()
    model_h = Zonos.from_config(zonos_v01_hybrid_config(), seed=0, dtype=torch.bfloat16, device="cuda").quantize()
    total, _result = _phase_server(card, single_rtf, model_h)
    print(PHASE10_RESULT, json.dumps(total), flush=True)
    return 0


def _child_phase(phase: int, args: list, marker: str) -> dict:
    """A phase in a child process (phases 10-12, 14 and 15): its timings are not
    raised by the profiler of phase 9, and its threads and CUDA work share
    nothing with this process's. The child's output is passed on line by
    line; it must exit 0. Returns the launch counts it prints after
    ``marker``."""
    t = time.perf_counter()
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), f"--phase{phase}", *args],
                            cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE, text=True)
    counts = None
    try:
        for line in proc.stdout:
            print(line, end="", flush=True)
            if line.startswith(marker):
                counts = json.loads(line[len(marker):])
        rc = proc.wait(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    print(f"phase{phase} process: exit {rc}, {time.perf_counter() - t:.1f} s", flush=True)
    if rc != 0 or counts is None:
        _fail(f"phase {phase}: the child process exited {rc}")
    return counts


# ---------------------------------------------------------------------------
# Phase 11: training, LoRA fine-tuning and speculative decode
# ---------------------------------------------------------------------------

TRAIN_TEXT = "Well met, traveler."
SPEC_FRAMES = 86  # 1 s of audio


def _kernel_wrappers():
    from zonos_tpu_torch.ops import cuda_attention as A
    from zonos_tpu_torch.ops import cuda_matmul as M

    return (M.int8_matmul, A.attn_core_int8, M.fused_mlp_int8, M.fused_mlp_int8_split, M.int4_matmul)


def _cos(a: torch.Tensor, b: torch.Tensor) -> float:
    """The cosine of two tensors, in float64 on ``a``'s device."""
    a, b = a.double().ravel(), b.to(a.device).double().ravel()
    return float(a @ b / (a.norm() * b.norm()).clamp(min=1e-300))


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """‖a − b‖ / ‖b‖ (0 when both are zero)."""
    d, n = float((a.double() - b.double()).norm()), float(b.double().norm())
    return d / n if n else d


def _train_check_2_layers(cfg):
    """Loss and gradients of ``loss_fn`` at 2 layers of full width on the card
    against the same weights on the CPU (f32, TF32 off): the loss within 1e-4
    relative and each leaf's gradient at cosine >= 0.9999; on the card
    ``accum_steps=2`` and ``remat=True`` give the plain step's loss and
    gradients within 1e-5 (norm of the difference over the norm)."""
    from zonos_tpu_torch.models.zonos import Zonos
    from zonos_tpu_torch.training import train as T
    from zonos_tpu_torch.training.data import build_batch, synthetic_dataset

    cpu = Zonos.from_config(cfg, seed=1, dtype=torch.float32, device="cpu")
    cond, delayed, mask = build_batch(cpu, synthetic_dataset(4, min_frames=24, max_frames=48, seed=1), frames=48)
    out = {"cond_tokens": int(cond.shape[1]), "targets": int(mask.sum()) * cfg.codebook_dimension}
    results = {}
    for dev in ("cpu", "cuda"):
        params = _tree_to({k: cpu.params[k] for k in ("embeddings", "heads", "backbone")}, dev)
        leaves = T.trainable_leaves(params)
        for accum, remat in ((1, False), (2, False), (1, True)) if dev == "cuda" else ((1, False),):
            loss, grads = T.value_and_grad(lambda c, d, m: T.loss_terms(params, cfg, c, d, m, remat=remat), leaves,
                                           accum, cond, delayed, mask)
            results[dev, accum, remat] = (float(loss), grads)
    names = [p for p, _ in T.named_leaves(cpu.params) if p.split("/")[0] in ("embeddings", "heads", "backbone")]
    l_cpu, g_cpu = results["cpu", 1, False]
    l_gpu, g_gpu = results["cuda", 1, False]
    out["loss_cpu"], out["loss_card"] = l_cpu, l_gpu
    out["loss_rel"] = abs(l_gpu - l_cpu) / abs(l_cpu)
    out["grad_cos_min"] = min(_cos(a, b) for a, b in zip(g_gpu, g_cpu))
    out["grad_cos"] = {n: _cos(a, b) for n, a, b in zip(names, g_gpu, g_cpu)}
    for tag, key in (("accum2", ("cuda", 2, False)), ("remat", ("cuda", 1, True))):
        loss, grads = results[key]
        out[f"{tag}_loss_rel"] = abs(loss - l_gpu) / abs(l_gpu)
        out[f"{tag}_grad_rel_max"] = max(_rel(a, b) for a, b in zip(grads, g_gpu))
    print("phase11 2-layer check:", json.dumps(out), flush=True)
    if out["loss_rel"] > 1e-4 or out["grad_cos_min"] < 0.9999:
        _fail(f"phase 11: 2-layer loss card/CPU {out['loss_rel']:.3g} relative, gradient cosine "
              f"{out['grad_cos_min']:.6f} (gates 1e-4, 0.9999)")
    for tag in ("accum2", "remat"):
        if out[f"{tag}_loss_rel"] > 1e-5 or out[f"{tag}_grad_rel_max"] > 1e-5:
            _fail(f"phase 11: {tag} differs from the plain step: loss {out[f'{tag}_loss_rel']:.3g}, "
                  f"gradients {out[f'{tag}_grad_rel_max']:.3g} (gate 1e-5)")
    return out


def _spec_vs_greedy(params, cfg, cond, dtype, kv_int8, frames=SPEC_FRAMES):
    """Greedy ``generate_speculative`` (self-draft) beside greedy ``generate`` at
    B 1: their codes, passes, acceptance and wall ms per frame; the
    speculative run's launch counts."""
    from zonos_tpu_torch.ops.sampling import SamplingParams
    from zonos_tpu_torch.runtime.generate import generate
    from zonos_tpu_torch.runtime.speculative import generate_speculative

    greedy = SamplingParams(temperature=0.0, repetition_penalty=1.0)
    kw = dict(max_new_tokens=frames, cfg_scale=2.0, sampling_params=greedy, seed=5, dtype=dtype, forbid_eos=True,
              kv_int8=kv_int8, device="cuda")
    with torch.no_grad():
        generate_speculative(params, cfg, cond, **{**kw, "max_new_tokens": 16})  # warm-up
        t = time.perf_counter()
        seq = generate(params, cfg, cond, **kw)
        seq_s = time.perf_counter() - t
        wrappers = _kernel_wrappers()
        for w in wrappers:
            w.launches = 0
        t = time.perf_counter()
        spec, stats = generate_speculative(params, cfg, cond, return_stats=True, **kw)
        spec_s = time.perf_counter() - t
        counts = {w.__name__: w.launches for w in wrappers}
    n = min(seq.shape[-1], spec.shape[-1])
    same = seq[..., :n] == spec[..., :n]
    differ = np.nonzero(~same.all(axis=(0, 1)))[0]
    return {
        "code_frames": int(spec.shape[-1]), **stats, "equal_share": float(same.mean()),
        "first_differing_frame": int(differ[0]) if differ.size else None,
        # both wall times over the output frames (the decode steps include n_q - 2 drain steps)
        "spec_s": spec_s, "greedy_s": seq_s,
        "spec_ms_per_frame": spec_s * 1e3 / spec.shape[-1], "greedy_ms_per_frame": seq_s * 1e3 / seq.shape[-1],
        "launches": counts,
    }, seq, spec


def _unmerged_logits(params, cfg, lora, scale, cond, codes):
    """``train.forward_logits`` with each adapter applied beside its frozen
    weight, x·W + scale·(x·A)·B, never merged: the reference ``merge_lora``
    is held against. Every target of every layer must be met once."""
    from zonos_tpu_torch.models import transformer as TR
    from zonos_tpu_torch.training import train as T

    factors = {}  # a layer's slice of a stacked weight is a view: its address names it
    for path, ad in lora.items():
        w = params["backbone"]
        for key in path.split("/"):
            w = w[key]
        for li in range(w.shape[0]):
            factors[w[li].data_ptr()] = (ad["a"][li], ad["b"][li])
    plain, met = TR.qeinsum, []

    def qeinsum(eq, x, w, out_dtype=None):
        y = plain(eq, x, w, out_dtype)
        ab = factors.get(w.data_ptr()) if isinstance(w, torch.Tensor) else None
        if ab is None:
            return y
        met.append(w.data_ptr())
        return y + scale * ((x @ ab[0]) @ ab[1])

    TR.qeinsum = qeinsum
    try:
        logits = T.forward_logits(params, cfg, cond, codes)
    finally:
        TR.qeinsum = plain
    if sorted(met) != sorted(factors):
        _fail(f"phase 11: the unmerged forward met {len(met)} adapted products, expected {len(factors)}")
    return logits


def _phase_train(card: str) -> dict:
    """Phase 11: the training path and speculative decode on the card. Returns
    the launch counts of the merged int8 model's generate and of the full-width
    speculative run."""
    from zonos_tpu_torch.bridge import params_from_jax
    from zonos_tpu_torch.conditioning.cond_dict import make_cond_dict
    from zonos_tpu_torch.config import zonos_v01_transformer_config
    from zonos_tpu_torch.models.zonos import Zonos
    from zonos_tpu_torch.ops.sampling import SamplingParams
    from zonos_tpu_torch.training import finetune_lora
    from zonos_tpu_torch.training import train as T
    from zonos_tpu_torch.training.data import build_batch, synthetic_dataset
    from zonos_tpu_torch.training.lora import merge_lora
    from zonos_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    full, frames = zonos_v01_transformer_config(), 256
    cfg2 = dataclasses.replace(full, backbone=dataclasses.replace(full.backbone, n_layer=2))
    _train_check_2_layers(cfg2)

    # speculative at 2 layers, f32 float weights: greedy equals generate's codes
    small = Zonos.from_config(cfg2, seed=2, dtype=torch.float32, device="cuda")
    cond = np.random.default_rng(2).normal(size=(2, 40, full.backbone.d_model)).astype(np.float32) * 0.05
    res2, seq2, spec2 = _spec_vs_greedy(small.params, cfg2, cond, torch.float32, kv_int8=False)
    print("phase11 speculative 2-layer f32:", json.dumps(res2), flush=True)
    if spec2.shape != seq2.shape or not np.array_equal(spec2, seq2):
        _fail(f"phase 11: 2-layer greedy speculative codes differ from generate's: {res2}")
    del small

    # LoRA fine-tune at full depth through the entry point's run()
    tmp = tempfile.mkdtemp(prefix="zonos_train_")
    try:
        args = finetune_lora.parse_args(["--model", "transformer", "--synthetic", "16", "--rank", "8", "--batch", "4",
                                         "--frames", str(frames), "--steps", "10", "--out", os.path.join(tmp, "a.npz")])
        t = time.perf_counter()
        model = finetune_lora.load_model(args)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        base = {p: v.cpu() for p, v in T.named_leaves(model.params)}  # a host copy: the peak stays the step's
        # samples of 192-256 frames, as the full step below draws: most positions are targets
        examples = synthetic_dataset(16, n_q=full.codebook_dimension, min_frames=frames * 3 // 4, max_frames=frames,
                                     seed=args.seed)
        torch.cuda.reset_peak_memory_stats()
        out = finetune_lora.run(args, model=model, examples=examples)
        lora_peak = torch.cuda.max_memory_allocated() / 1e9
        losses, state = out["losses"], out["state"]
        changed = [p for p, v in T.named_leaves(model.params) if not torch.equal(v.cpu(), base[p])]
        b_zero = [t_ for t_, a in state.lora.items() if not a["b"].any()]
        steady = out["step_s"][1:]  # the first step allocates
        lora = {"init_s": init_s, "losses": losses, "s_per_step": float(np.median(steady)),
                "targets_per_s": sum(out["targets"][1:]) / sum(steady), "targets": out["targets"],
                "positions_per_step": out["positions_per_step"], "peak_mem_gb": lora_peak,
                "first_step_s": out["step_s"][0]}
        if not all(np.isfinite(losses)) or changed or b_zero:
            _fail(f"phase 11: LoRA losses {losses}, base leaves changed {changed}, B still zero in {b_zero}")

        # the merged weights through the native checkpoint (what --merge writes) against the
        # adapter applied beside the frozen weights, never merged
        with torch.no_grad():
            merged = dict(model.params)
            merged["backbone"] = merge_lora(model.params["backbone"], state.lora, scale=args.scale)
            t = time.perf_counter()
            save_checkpoint(os.path.join(tmp, "merged"), merged, config=full)
            lora["merge_write_s"] = time.perf_counter() - t
            del merged
            t = time.perf_counter()
            merged = load_checkpoint(os.path.join(tmp, "merged"), device="cuda")
            lora["merge_read_s"] = time.perf_counter() - t
            c, dl, _m = build_batch(model, synthetic_dataset(2, seed=9, min_frames=frames // 4,
                                                             max_frames=frames // 2), frames=frames // 2)
            got = T.forward_logits(merged, full, c, dl[..., :-1])
            params = {k: model.params[k] for k in ("embeddings", "heads", "backbone")}
            ref = _unmerged_logits(params, full, state.lora, args.scale, c, dl[..., :-1])
            base_logits = T.forward_logits(params, full, c, dl[..., :-1])
        lora["merged_logits_rel"] = _rel(got, ref)
        lora["merged_effect_rel"] = _rel(got - base_logits, ref - base_logits)
        lora["adapter_effect_rel"] = _rel(ref, base_logits)
        del got, ref, base_logits
        print("phase11 lora:", json.dumps(lora), f"card: {card}", flush=True)
        if lora["merged_logits_rel"] > 1e-4:
            _fail(f"phase 11: merged checkpoint logits differ from the unmerged adapter forward: "
                  f"{lora['merged_logits_rel']}")

        # the merged model as a user deploys it: bf16, int8, generate through K1-K3
        deploy = Zonos(full, params_from_jax(_to_numpy(merged), device="cuda", dtype=torch.bfloat16),
                       dtype=torch.bfloat16, device="cuda").quantize()
        del merged
        torch.cuda.empty_cache()
        tcond = deploy.prepare_conditioning(make_cond_dict(text=TRAIN_TEXT, speaker=np.zeros((1, 1, 128), np.float32)))
        wrappers = _kernel_wrappers()
        with torch.no_grad():
            for w_ in wrappers:
                w_.launches = 0
            stats = {}
            codes = deploy.generate(tcond, max_new_tokens=SPEC_FRAMES, cfg_scale=2.0, seed=1, forbid_eos=True,
                                    sampling_params=SamplingParams(min_p=0.1), stats=stats)
            lora_counts = {w_.__name__: w_.launches for w_ in wrappers}
        steps, L = stats["decode_steps"], full.backbone.n_layer
        expected = {"int8_matmul": steps * (2 * L + 1) + 1, "attn_core_int8": steps * L,
                    "fused_mlp_int8": steps * L, "fused_mlp_int8_split": 0, "int4_matmul": 0}
        print("phase11 merged int8 generate:", json.dumps({"frames": int(codes.shape[-1]), "decode_steps": steps,
              "decode_ms_per_frame": stats["decode_s"] * 1e3 / steps, "launches": lora_counts,
              "expected": expected}), flush=True)
        if lora_counts != expected or codes.shape != (1, 9, SPEC_FRAMES) or codes.min() < 0 or codes.max() > 1023:
            _fail(f"phase 11: merged int8 generate: launches {lora_counts} (expected {expected}), codes "
                  f"{codes.shape}")

        # speculative at full width, int8, B 1, self-draft: printed, not gated on equality
        spec, _seq, _spec = _spec_vs_greedy(deploy.params, full, tcond, torch.bfloat16, kv_int8=True)
        spec_expected = {"int8_matmul": spec["passes"] + 1, "attn_core_int8": 0, "fused_mlp_int8": 0,
                         "fused_mlp_int8_split": 0, "int4_matmul": 0}
        print("phase11 speculative int8:", json.dumps(spec), "expected:", json.dumps(spec_expected),
              f"card: {card}", flush=True)
        if spec["launches"] != spec_expected or spec["code_frames"] < SPEC_FRAMES:
            _fail(f"phase 11: speculative launches {spec['launches']} (expected {spec_expected}), "
                  f"{spec['code_frames']} frames")
        del deploy
        torch.cuda.empty_cache()

        # the full train step at full depth: 3 AdamW steps on the flagship
        params = {k: model.params[k] for k in ("embeddings", "heads", "backbone")}
        opt = T.make_optimizer(lr=1e-4, warmup=1)
        torch.cuda.reset_peak_memory_stats()
        tstate = T.init_train_state(params, opt)
        step = T.build_train_step(full, opt)
        batch = build_batch(model, synthetic_dataset(4, min_frames=frames * 3 // 4, max_frames=frames, seed=3),
                            frames=frames)
        step_s, losses = [], []
        for _ in range(3):
            t = time.perf_counter()
            tstate, loss = step(tstate, *batch)
            losses.append(float(loss))
            step_s.append(time.perf_counter() - t)
        finite = all(bool(torch.isfinite(v).all()) for _, v in T.named_leaves(params))
        n_targets = T.count_targets(batch[1], batch[2], full.head_vocab_size)
        full_res = {"losses": losses, "step_s": step_s, "s_per_step": float(np.median(step_s[1:])),
                    "targets": n_targets, "positions_per_step": 4 * (frames + full.codebook_dimension - 1),
                    "targets_per_s": n_targets / float(np.median(step_s[1:])),
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "params_finite": finite}
        print("phase11 full train step:", json.dumps(full_res), f"card: {card}", flush=True)
        if not (all(np.isfinite(losses)) and finite):
            _fail(f"phase 11: full train step losses {losses}, params finite {finite}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"lora_int8": lora_counts, "speculative": spec["launches"]}


PHASE11_RESULT = "phase11 result:"


def _phase_train_main() -> int:
    """``--phase11``: phase 11 in a process of its own (started by
    ``_child_phase``). Prints the launch counts as its last line."""
    from zonos_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()  # built by the parent: finds every library
    t = time.perf_counter()
    counts = _phase_train(_card_line())
    print(f"phase11 total: {time.perf_counter() - t:.1f} s", flush=True)
    print(PHASE11_RESULT, json.dumps(counts), flush=True)
    return 0


# ---------------------------------------------------------------------------
# Phase 12: tensor and data parallelism on torch.distributed
# ---------------------------------------------------------------------------

PHASE12_RESULT = "phase12 result:"
# tp 2 at full depth over gloo takes ~157 ms a frame: 43 frames keep the
# default run inside its 1,200 s on a slow host
PAR_FRAMES, PAR_HYBRID_FRAMES = 43, 32
WARM_FRAMES = 8  # a warm-up generate before each timed one


def _par_configs(device="cuda", train: bool = False) -> dict:
    """Phase 12's models at full width: the flagship at full depth (2 layers
    for training), the hybrid with 2 layers (one Mamba, one attention), as
    phase 4 cuts it. On the CPU (a rehearsal) the tiny configs."""
    from zonos_tpu_torch import config as C

    if torch.device(device).type == "cpu":
        return {"transformer": C.tiny_transformer_config(), "hybrid": C.tiny_hybrid_config()}
    t, h = C.zonos_v01_transformer_config(), C.zonos_v01_hybrid_config()
    if train:
        t = dataclasses.replace(t, backbone=dataclasses.replace(t.backbone, n_layer=2, attn_layer_idx=(0, 1)))
    return {"transformer": t,
            "hybrid": dataclasses.replace(h, backbone=dataclasses.replace(h.backbone, n_layer=2, attn_layer_idx=(1,)))}


def _par_model(cfg, device):
    """The seeded int8 model whose params every rank builds for itself."""
    from zonos_tpu_torch.models.zonos import Zonos

    return Zonos.from_config(cfg, seed=0, dtype=torch.bfloat16, device=device).quantize().params


def _par_cond(d: int, b: int = 1, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(2 * b, 80, d)).astype(np.float32) * 0.05


def _decode_job(params, cfg, cond, frames, sampling, device, mesh=None, batch_size=1, seed=0):
    """One generate (int8 KV, EOS forbidden) with every launch count set to 0
    before it → (codes, the prefill's guided logits, stats, launch counts)."""
    from zonos_tpu_torch.runtime import streaming
    from zonos_tpu_torch.runtime.generate import generate

    wrappers = _kernel_wrappers()
    for k in wrappers:
        k.launches = 0
    first = []
    sample = streaming.sample_from_logits

    def recording(logits, *a, **k):
        if not first:
            first.append(logits.float().cpu())
        return sample(logits, *a, **k)

    streaming.sample_from_logits = recording
    try:
        stats = {}
        codes = generate(params, cfg, cond, max_new_tokens=frames, cfg_scale=2.0, batch_size=batch_size,
                         sampling_params=sampling, seed=seed, forbid_eos=True, kv_int8=True, stats=stats,
                         device=device, mesh=mesh)
    finally:
        streaming.sample_from_logits = sample
    return codes, first[0], stats, {k.__name__: k.launches for k in wrappers}


def _forced_agreement(params, cfg, cond, codes, device, mesh=None) -> dict:
    """Teacher forcing of greedy codes [B, n_q, T] from another run (cond
    [2B, ...]: the same rows of both CFG halves): this model's greedy pick
    at each step of generate's loop (after the bias and the repetition
    penalty) while the step's input frame holds given codes only, that input
    taken from ``codes``; the share of (row, step, codebook) picks equal to
    the given token."""
    from zonos_tpu_torch.ops.delay_pattern import apply_delay_pattern_np
    from zonos_tpu_torch.ops.sampling import SamplingParams, sample_from_logits
    from zonos_tpu_torch.parallel.mesh import local_config
    from zonos_tpu_torch.runtime.generate import _context_slice, _decode_logits, prepare_request
    from zonos_tpu_torch.runtime.streaming import _make_bias, build_prefill_fn

    greedy = SamplingParams(temperature=0.0)
    b, n_q, t = codes.shape
    lcfg = cfg if mesh is None else local_config(cfg, mesh.tp)
    req = prepare_request(lcfg, cond, None, t, 2.0, b, greedy, 0, torch.bfloat16, True, True, device)
    st = req.statics
    c = build_prefill_fn(st)(params, req.cond_padded, req.delayed_init, 1, req.pad_amount, 2.0, req.generators,
                             mesh=mesh)
    forced = torch.as_tensor(apply_delay_pattern_np(codes.astype(np.int32), cfg.masked_token_id), device=device)
    d = c.delayed_codes
    picks = [d[:, :, 1].cpu()]  # the prefill's pick: delayed index 1
    d[:, :, 1] = forced[:, :, 1]
    bias = _make_bias(st, device)
    for o in range(2, t + 2):  # the last step whose input frame is all given codes (or leading MASKs)
        logits, c.cache = _decode_logits(params, st, d[:, :, o - 1:o], c.cache, st.prefill_len + o - 2,
                                         req.pad_amount, 2.0, mesh=mesh)
        ctx, valid = _context_slice(d, o, st.sampling.repetition_penalty_window)
        picks.append(sample_from_logits(logits + bias, greedy, generated_tokens=ctx, generated_valid_len=valid)
                     .cpu())
        d[:, :, o] = forced[:, :, o]
    agree = compared = 0
    for j, pick in enumerate(picks):  # pick j chose delayed index j + 1: codebook k's frame j - k
        for r in range(b):
            for k in range(n_q):
                f = j - k
                if 0 <= f < t and codes[r, k, f] < 1024:
                    compared += 1
                    agree += int(pick[r, k]) == int(codes[r, k, f])
    return {"compared": compared, "agree": agree, "share": agree / max(compared, 1)}


def _par_infer_rank(backend, device, refs, frames):
    """A rank of the 2-rank inference group: tp = 2 for each model (greedy
    codes, first logits and launch counts, teacher forcing along the
    one-device codes ``refs[name]``, then min-p 0.1), and dp = 2 over 4 rows
    of the flagship (min-p 0.1, one int seed) with the one-device generate of
    this rank's 2 rows at their global seeds."""
    from zonos_tpu_torch.ops.sampling import SamplingParams
    from zonos_tpu_torch.parallel.mesh import batch_rows, make_mesh, shard_params
    from zonos_tpu_torch.runtime.generate import _cfg_rows, postprocess_codes_batched, prepare_request, run_request

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    greedy, min_p = SamplingParams(temperature=0.0), SamplingParams(min_p=0.1)
    tp = make_mesh(dp=1, tp=2, backend=backend, device=device)
    dp = make_mesh(dp=2, tp=1, backend=backend, device=device)
    dev = tp.device
    with torch.no_grad():
        for name, cfg in _par_configs(dev).items():
            full = _par_model(cfg, dev)
            if name == "transformer":  # dp first: it runs the whole model
                cond4 = _par_cond(cfg.backbone.d_model, b=4, seed=3)
                _decode_job(full, cfg, cond4, WARM_FRAMES, min_p, dev, mesh=dp, batch_size=4, seed=5)
                codes, _, stats, counts = _decode_job(full, cfg, cond4, frames[name], min_p, dev, mesh=dp,
                                                      batch_size=4, seed=5)
                rows = batch_rows(dp, 4)
                req = prepare_request(cfg, _cfg_rows(cond4, rows, 4), None, frames[name], 2.0, 2, min_p, 5,
                                      torch.bfloat16, True, True, dev, first_row=rows.start)
                ref, _ = postprocess_codes_batched(*run_request(full, req, 2.0), cfg)
                out["dp2"] = {"codes": codes, "rows": (rows.start, rows.stop), "ref": ref, "stats": stats,
                              "counts": counts}
            local = shard_params(tp, cfg, full)
            del full
            cond = _par_cond(cfg.backbone.d_model)
            _decode_job(local, cfg, cond, WARM_FRAMES, greedy, dev, mesh=tp)
            codes, logits, stats, counts = _decode_job(local, cfg, cond, frames[name], greedy, dev, mesh=tp)
            forced = _forced_agreement(local, cfg, cond, refs[name]["codes"], dev, mesh=tp)
            mp_codes, _, mp_stats, _ = _decode_job(local, cfg, cond, frames[name], min_p, dev, mesh=tp, seed=7)
            out[name] = {"codes": codes, "corr": _corr(logits, refs[name]["logits"]), "stats": stats,
                         "counts": counts, "forced": forced, "min_p_codes": mp_codes, "min_p_stats": mp_stats}
            del local
    return out


def _par_train_rank(backend, device, steps):
    """A rank of the dp 2 × tp 2 training group, f32 with TF32 off: at 2
    layers of full width, the sharded loss and this rank's gradients against
    the one-device loss_fn's (computed here on the same weights), then
    ``steps`` sharded AdamW steps (warmup 1) on the fixed batch."""
    from zonos_tpu_torch.models.zonos import Zonos
    from zonos_tpu_torch.parallel.mesh import local_config, make_mesh, shard_params, shard_tree
    from zonos_tpu_torch.training import train as T

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(dp=2, tp=2, backend=backend, device=device)
    dev = mesh.device
    out = {}
    for name, full in _par_configs(dev, train=True).items():
        m = Zonos.from_config(full, seed=1, dtype=torch.float32, device=dev)
        params = {k: m.params[k] for k in ("embeddings", "heads", "backbone")}
        del m
        rng = np.random.default_rng(2)
        d = full.backbone.d_model
        cond = rng.normal(size=(4, 32, d)).astype(np.float32) * 0.05
        codes = rng.integers(0, 1024, size=(4, 9, 48)).astype(np.int32)
        mask = np.ones((4, 47), bool)
        mask[1, 30:] = False
        leaves = T.trainable_leaves(params)
        loss1, g1 = T.value_and_grad(lambda c, dc, mk: T.loss_terms(params, full, c, dc, mk), leaves, 1,
                                     cond, codes, mask)
        names = [p for p, t in T.named_leaves(params) if t.is_floating_point()]
        g1_local = dict(T.named_leaves(shard_tree(full, _tree_of(params, names, g1), mesh.tp, mesh.tp_rank)))
        del g1
        local = shard_params(mesh, full, params)
        lcfg = local_config(full, mesh.tp)
        batch = T.shard_batch(mesh, cond, codes, mask)
        lleaves = T.trainable_leaves(local)
        loss, g = T.sharded_value_and_grad(
            mesh, lambda c, dc, mk: T.loss_terms(local, lcfg, c, dc, mk, mesh=mesh), lleaves, 1, *batch)
        lnames = [p for p, t in T.named_leaves(local) if t.is_floating_point()]
        cos = {p: _cos(a, g1_local[p]) for p, a in zip(lnames, g)}
        del g, g1_local, local
        opt = T.make_optimizer(lr=1e-3, warmup=1)
        state, step = T.make_sharded_train_step(mesh, full, opt, params)
        losses, secs = [], []
        for _ in range(steps):
            t = time.perf_counter()
            state, lo = step(state, *batch)
            lo = float(lo)  # syncs
            secs.append(time.perf_counter() - t)
            losses.append(lo)
        out[name] = {"loss": float(loss), "loss_one_device": float(loss1),
                     "loss_rel": abs(float(loss) - float(loss1)) / abs(float(loss1)),
                     "grad_cos_min": min(cos.values()), "grad_cos_argmin": min(cos, key=cos.get),
                     "losses": losses, "s_per_step": secs}
        del state, params
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _tree_of(tree, names, flat):
    """{path: tensor} of ``names`` → ``tree``'s nested shape (lists kept)."""
    lookup = dict(zip(names, flat))

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, f"{path}{k}/") for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, f"{path}{i}/") for i, v in enumerate(t))
        return None if t is None else lookup[path[:-1]]

    return walk(tree, "")


def _phase_parallel(card: str) -> dict:
    """Phase 12: tp = 2 and dp = 2 inference and the dp 2 × tp 2 train step,
    as ranks spawned on the one card over gloo. Returns the launch counts of
    the tp and dp runs per path."""
    from zonos_tpu_torch.ops.sampling import SamplingParams
    from zonos_tpu_torch.parallel.mesh import spawn

    t0 = time.perf_counter()
    frames = {"transformer": PAR_FRAMES, "hybrid": PAR_HYBRID_FRAMES}
    refs, one = {}, {}
    with torch.no_grad():
        for name, cfg in _par_configs().items():  # the one-device runs, before the ranks start
            params = _par_model(cfg, "cuda")
            cond = _par_cond(cfg.backbone.d_model)
            _decode_job(params, cfg, cond, WARM_FRAMES, SamplingParams(temperature=0.0), "cuda")
            codes, logits, stats, _ = _decode_job(params, cfg, cond, frames[name], SamplingParams(temperature=0.0),
                                                  "cuda")
            refs[name] = {"codes": codes, "logits": logits}
            one[name] = stats["decode_s"] * 1e3 / stats["decode_steps"]
            del params
    torch.cuda.empty_cache()
    print(f"phase12 backend gloo, world 2 (tp 2; dp 2) then 4 (dp 2 x tp 2), ranks on one card: {card}", flush=True)
    t = time.perf_counter()
    infer = spawn(_par_infer_rank, 2, "gloo", "cuda", refs, frames, timeout=600)
    infer_s = time.perf_counter() - t
    t = time.perf_counter()
    train = spawn(_par_train_rank, 4, "gloo", "cuda", 3, timeout=600)
    train_s = time.perf_counter() - t

    counts_by_path = {}
    for name, cfg in _par_configs().items():
        L = cfg.backbone.n_layer
        n_attn = len(cfg.backbone.attn_layer_idx)
        per_rank = [r[name] for r in infer]
        if not all(np.array_equal(p["codes"], per_rank[0]["codes"]) for p in per_rank) or \
                not all(np.array_equal(p["min_p_codes"], per_rank[0]["min_p_codes"]) for p in per_rank):
            _fail(f"phase 12: tp {name}: the two tp ranks' codes differ")
        for p in per_rank:
            steps = p["stats"]["decode_steps"]
            # per step: in_proj + out_proj per layer and the heads on K1, K2 per
            # attention layer, K3 per MLP; the prefill's heads on K1
            want = {"int8_matmul": steps * (2 * L + 1) + 1, "attn_core_int8": steps * n_attn,
                    "fused_mlp_int8": steps * L, "fused_mlp_int8_split": 0, "int4_matmul": 0}
            if p["counts"] != want:
                _fail(f"phase 12: tp {name} launch counts {p['counts']} != expected {want}")
            if p["codes"].shape != (1, cfg.codebook_dimension, frames[name]):
                _fail(f"phase 12: tp {name} codes shape {p['codes'].shape}")
        res = {
            "frames": frames[name], "layers": L,
            "first_logits_corr": min(p["corr"] for p in per_rank),
            "forced_agreement": min(p["forced"]["share"] for p in per_rank),
            "forced_compared": per_rank[0]["forced"]["compared"],
            "greedy_equal_share": float(np.mean(per_rank[0]["codes"] == refs[name]["codes"])),
            "ms_per_frame_tp2": [p["stats"]["decode_s"] * 1e3 / p["stats"]["decode_steps"] for p in per_rank],
            "ms_per_frame_tp2_min_p": [p["min_p_stats"]["decode_s"] * 1e3 / p["min_p_stats"]["decode_steps"]
                                       for p in per_rank],
            "ms_per_frame_one_device": one[name],
            "prefill_ms_tp2": [p["stats"]["prefill_s"] * 1e3 for p in per_rank],
        }
        print(f"phase12 tp2 {name}:", json.dumps(res), flush=True)
        if res["first_logits_corr"] < 0.999 or res["forced_agreement"] < 0.90:
            _fail(f"phase 12: tp {name}: first-step logits corr {res['first_logits_corr']:.6f} (gate 0.999), "
                  f"teacher-forced agreement {res['forced_agreement']:.4f} (gate 0.90)")
        counts_by_path["tp2" if name == "transformer" else "tp2_hybrid"] = per_rank[0]["counts"]

    cfg = _par_configs()["transformer"]
    dp_all = [r["dp2"] for r in infer]
    for p in dp_all:
        lo, hi = p["rows"]
        if p["codes"].shape != (4, cfg.codebook_dimension, PAR_FRAMES) or not np.array_equal(p["codes"][lo:hi],
                                                                                            p["ref"]):
            _fail(f"phase 12: dp rows {lo}-{hi} differ from the one-device generate of those rows")
        if not np.array_equal(p["codes"], dp_all[0]["codes"]):
            _fail("phase 12: the dp ranks returned different codes")
        steps = p["stats"]["decode_steps"]
        want = {"int8_matmul": steps * 49 + 1, "attn_core_int8": steps * 24, "fused_mlp_int8": steps * 24,
                "fused_mlp_int8_split": 0, "int4_matmul": 0}
        if p["counts"] != want:
            _fail(f"phase 12: dp launch counts {p['counts']} != expected {want}")
    counts_by_path["dp2"] = dp_all[0]["counts"]
    print("phase12 dp2 transformer (B 4, 2 rows per rank):", json.dumps({
        "rows_bit_equal": True, "ms_per_frame": [p["stats"]["decode_s"] * 1e3 / p["stats"]["decode_steps"]
                                                 for p in dp_all]}), flush=True)

    for name in ("transformer", "hybrid"):
        per_rank = [r[name] for r in train]
        res = {"loss": per_rank[0]["loss"], "loss_one_device": per_rank[0]["loss_one_device"],
               "loss_rel": max(p["loss_rel"] for p in per_rank),
               "grad_cos_min": min(p["grad_cos_min"] for p in per_rank),
               "grad_cos_argmin": min(per_rank, key=lambda p: p["grad_cos_min"])["grad_cos_argmin"],
               "losses": per_rank[0]["losses"], "s_per_step": [p["s_per_step"] for p in per_rank]}
        print(f"phase12 train dp2 x tp2 {name} (2 layers):", json.dumps(res), flush=True)
        losses = res["losses"]
        if res["loss_rel"] > 1e-4 or res["grad_cos_min"] < 0.9999:
            _fail(f"phase 12: sharded {name} loss {res['loss_rel']:.3g} relative, gradient cosine "
                  f"{res['grad_cos_min']:.6f} (gates 1e-4, 0.9999)")
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            _fail(f"phase 12: sharded {name} steps: losses {losses} not finite and falling")
        if any(p["losses"] != losses for p in per_rank):
            _fail(f"phase 12: sharded {name}: the ranks' losses differ")
    print(f"phase12 spawn seconds: inference {infer_s:.1f}, training {train_s:.1f}; total "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return counts_by_path


def _phase_parallel_main() -> int:
    """``--phase12``: phase 12 in a process of its own (started by
    ``_child_phase``). Prints the launch counts as its last line."""
    from zonos_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()  # built by the parent: finds every library
    counts = _phase_parallel(_card_line())
    print(PHASE12_RESULT, json.dumps(counts), flush=True)
    return 0


# ---------------------------------------------------------------------------
# Phase 14: the repository's commands (zonos_tpu_torch.tools)
# ---------------------------------------------------------------------------

PHASE14_RESULT = "phase14 result:"
G2P_ENTRIES, G2P_CODES = 199, 109  # tests/data/g2p_golden.json
EXPORT_FRAMES = 32  # greedy int8 frames of the exported model against its source's


def _expected_int8(steps: list, n_layer: int, attn_layers: int | None = None, prefills: int | None = None) -> dict:
    """K1-K3 launches of int8 decodes of ``steps`` decode steps each: per step
    in_proj and out_proj per layer (a Mamba layer's or attention's) and the
    output heads on K1, one K3 per layer and one K2 per attention layer (all
    ``n_layer`` unless ``attn_layers`` is given); each prefill's
    last-position heads on K1 (one per decode unless ``prefills`` is given)."""
    n = sum(steps)
    return {"int8_matmul": n * (2 * n_layer + 1) + (len(steps) if prefills is None else prefills),
            "attn_core_int8": n * (n_layer if attn_layers is None else attn_layers),
            "fused_mlp_int8": n * n_layer, "fused_mlp_int8_split": 0, "int4_matmul": 0}


def _commands_config(device):
    from zonos_tpu_torch.config import tiny_transformer_config, zonos_v01_transformer_config

    return zonos_v01_transformer_config() if device == "cuda" else tiny_transformer_config()


def _phase_g2p() -> None:
    """``make_g2p_golden --diff`` on this host: no entry of the snapshot changed."""
    from zonos_tpu_torch.tools import make_g2p_golden

    t = time.perf_counter()
    rc = make_g2p_golden.main(["--diff"])
    golden = make_g2p_golden.build()
    n = sum(len(rows) for rows in golden.values())
    print(f"phase14 make_g2p_golden --diff: exit {rc} over {n} entries of {len(golden)} codes "
          f"({time.perf_counter() - t:.2f} s for both passes)", flush=True)
    if rc != 0 or (n, len(golden)) != (G2P_ENTRIES, G2P_CODES):
        _fail(f"phase 14: make_g2p_golden --diff exit {rc}, {n} entries of {len(golden)} codes")


def _phase_demo(card: str, device: str) -> dict:
    """``e2e_demo`` on the flagship (the card) or the tiny model (the CPU) in a
    temporary working directory: three 44.1 kHz wavs of finite PCM, equal to
    what ``tts`` returned, long_cold equal to long_warm sample for sample, and
    K1-K3's launches exact over the three requests. Returns the launch counts."""
    from zonos_tpu_torch.audio.io import read_wav
    from zonos_tpu_torch.tools import e2e_demo

    wrappers = _kernel_wrappers()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as work:
        os.chdir(work)
        try:
            t = time.perf_counter()
            model = e2e_demo.load_model("transformer" if device == "cuda" else "tiny", device)
            print(f"phase14 demo model load (seeded preset, int8 quantize): {time.perf_counter() - t:.1f} s",
                  flush=True)
            for w in wrappers:
                w.launches = 0
            results = e2e_demo.run(model)
            counts = {w.__name__: w.launches for w in wrappers}
            files = {r["name"]: read_wav(os.path.join(work, r["path"])) for r in results}
        finally:
            os.chdir(cwd)
    for r in results:
        wav, sr = files[r["name"]]
        pcm = np.round(wav[0] * 32768.0).astype(np.int16)
        if sr != 44100 or r["sr"] != 44100 or not np.isfinite(wav).all() or wav.shape[-1] == 0:
            _fail(f"phase 14: demo_{r['name']}.wav: {sr} Hz, {wav.shape[-1]} samples, finite "
                  f"{bool(np.isfinite(wav).all())}")
        if not np.array_equal(pcm, r["wav"]):
            _fail(f"phase 14: demo_{r['name']}.wav differs from the PCM tts returned")
        steps = r["stats"]["decode_steps"]
        print(f"phase14 demo {r['name']}:", json.dumps({
            "audio_s": r["audio_s"], "wall_s": r["wall_s"], "rtf": r["rtf"], "decode_steps": steps,
            "ms_per_frame": r["wall_s"] * 1e3 / steps, "prefill_ms": r["stats"]["prefill_s"] * 1e3,
            "segments_s": r["stats"]["segments_s"], "dac_s": r["stats"]["dac_s"],
            "pcm_rms": float(np.sqrt(np.mean(r["wav"].astype(np.float64) ** 2)))}), f"card: {card}", flush=True)
    cold, warm = results[1]["wav"], results[2]["wav"]
    same = cold.shape == warm.shape and np.array_equal(cold, warm)
    print(f"phase14 demo long_cold == long_warm sample for sample: {same}", flush=True)
    if not same:
        n = min(cold.shape[-1], warm.shape[-1])
        diff = np.flatnonzero(cold[:n] != warm[:n])
        _fail(f"phase 14: long_cold {cold.shape} and long_warm {warm.shape} differ in {diff.size} of the first {n} "
              f"samples, from sample {diff[:1].tolist()}")
    if device == "cuda":
        expected = _expected_int8([r["stats"]["decode_steps"] for r in results], model.config.backbone.n_layer)
        print("phase14 demo launches:", json.dumps(counts), "expected:", json.dumps(expected), flush=True)
        if counts != expected:
            _fail(f"phase 14: demo launch counts {counts} != expected {expected}")
    return counts


def _phase_export(card: str, device: str) -> dict:
    """The seeded bf16 model saved natively, exported by ``export_checkpoint``,
    validated by ``validate_checkpoint`` (load PASS, every other row SKIP,
    exit 0) and read back by ``from_local``: every param bit-equal, and
    EXPORT_FRAMES greedy int8 frames equal to the source's. Returns the int8
    launch counts of the two greedy runs."""
    from zonos_tpu_torch.models.zonos import Zonos
    from zonos_tpu_torch.tools import export_checkpoint, validate_checkpoint
    from zonos_tpu_torch.utils.checkpoint import save_checkpoint

    cfg = _commands_config(device)
    src = Zonos.from_config(cfg, seed=0, dtype=torch.bfloat16, device=device)
    info = {}
    with tempfile.TemporaryDirectory() as tmp:
        native, ref = os.path.join(tmp, "native"), os.path.join(tmp, "ref")
        t = time.perf_counter()
        save_checkpoint(native, src.params, cfg)
        info["save_s"] = time.perf_counter() - t
        t = time.perf_counter()
        rc = export_checkpoint.main(["--checkpoint", native, "--out", ref, "--device", device])
        info["export_s"] = time.perf_counter() - t
        cpath, wpath = os.path.join(ref, "config.json"), os.path.join(ref, "model.safetensors")
        info["native_bytes"] = os.path.getsize(os.path.join(native, "params.pt"))
        info["export_bytes"] = os.path.getsize(wpath)
        t = time.perf_counter()
        rows = validate_checkpoint.validate(cpath, wpath, device=device)
        status = 0 if validate_checkpoint.print_table(rows) else 1
        info["validate_s"] = time.perf_counter() - t
        t = time.perf_counter()
        loaded = Zonos.from_local(cpath, wpath, dtype=torch.bfloat16, device=device)
        info["load_s"] = time.perf_counter() - t
    print("phase14 export:", json.dumps(info), f"card: {card}", flush=True)
    want = {"load": "PASS", "backbone": "SKIP", "dac": "SKIP", "speaker": "SKIP"}
    got = {r.name: r.status for r in rows}
    if rc != 0 or status != 0 or got != want or not all(r.detail for r in rows[1:]):
        _fail(f"phase 14: export exit {rc}, validate exit {status}, rows {got} (expected {want})")
    bad = _tree_diff(src.params, loaded.params)
    if loaded.config != src.config or bad:
        _fail(f"phase 14: the export read back differs: config equal {loaded.config == src.config}, params {bad[:5]}")
    print("phase14 export read back: config equal, every param bit-equal", flush=True)

    cond = np.random.default_rng(0).normal(size=(2, 80, cfg.backbone.d_model)).astype(np.float32) * 0.05
    models = [src.quantize(), loaded.quantize()]
    del src, loaded
    wrappers = _kernel_wrappers()
    for w in wrappers:
        w.launches = 0
    codes, steps = [], []
    with torch.no_grad():
        for m in models:
            stats = {}
            codes.append(m.generate(cond, max_new_tokens=EXPORT_FRAMES, sampling_params={"temperature": 0.0},
                                    forbid_eos=True, stats=stats))
            steps.append(stats["decode_steps"])
    counts = {w.__name__: w.launches for w in wrappers}
    same = codes[0].shape == codes[1].shape and np.array_equal(codes[0], codes[1])
    print(f"phase14 export greedy int8 {EXPORT_FRAMES} frames, source vs export: codes equal {same}", flush=True)
    if not same:
        _fail(f"phase 14: greedy int8 codes of the export differ from the source's ({codes[0].shape}, {codes[1].shape})")
    if device == "cuda":
        expected = _expected_int8(steps, cfg.backbone.n_layer)
        print("phase14 export launches:", json.dumps(counts), "expected:", json.dumps(expected), flush=True)
        if counts != expected:
            _fail(f"phase 14: export launch counts {counts} != expected {expected}")
    return counts


def _phase_commands(card: str, device: str = "cuda") -> dict:
    """Phase 14 (the card; at tiny size on the CPU, a rehearsal in which no
    kernel runs): the G2P snapshot, the demo, export → validate → reload and
    profile_components at 86 frames. Returns launch counts by path."""
    from zonos_tpu_torch.tools import profile_components

    t0 = time.perf_counter()
    _phase_g2p()
    demo = _phase_demo(card, device)
    if device == "cuda":
        torch.cuda.empty_cache()
    export = _phase_export(card, device)
    if device == "cuda":
        torch.cuda.empty_cache()
    with torch.no_grad():
        prof = profile_components.profile(_commands_config(device), frames=(86,), device=device)
    print("phase14 profile_components:", json.dumps(prof), flush=True)
    print(f"phase14 total: {time.perf_counter() - t0:.1f} s", flush=True)
    return {"demo": demo, "export_int8": export}


def _phase_commands_main() -> int:
    """``--phase14``: phase 14 in a process of its own (started by
    ``_child_phase``). Prints the launch counts as its last line."""
    from zonos_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()  # built by the parent: finds every library
    counts = _phase_commands(_card_line())
    print(PHASE14_RESULT, json.dumps(counts), flush=True)
    return 0


# ---------------------------------------------------------------------------
# Phase 15: the benchmark (zonos_tpu_torch.tools.bench)
# ---------------------------------------------------------------------------

PHASE15_RESULT = "phase15 result:"
# the bench's module constants, cut so that the phase fits the default run:
# requests of 1 s, one timed run per leg, 6 sustained engine requests of 1 s
BENCH_CUTS = {"SECONDS": 1.0, "N_RUNS": 1, "HYBRID_RUNS": 1, "ENGINE_SECONDS": 1.0, "ENGINE_REQUESTS": 6}


def _phase_bench(card: str, device: str = "cuda") -> dict:
    """``bench.main(["--device", device])`` with ``BENCH_CUTS``, each leg
    wrapped so that its launch counts are set to 0 just before it and read
    just after it. Checks the JSON line's keys, every number finite and > 0,
    K1-K3's launches exact on every leg but the TTFA one (K1-K3 launched
    there), and every engine request's PCM finite and non-empty. On the CPU
    (a rehearsal at ``ZONOS_BENCH_PRESET=tiny``, where no kernel runs) the
    launch counts are not checked. Returns the legs' launch counts summed."""
    import contextlib
    import io

    from zonos_tpu_torch import config as C
    from zonos_tpu_torch.tools import bench

    for var in ("ZONOS_BENCH_PRESET", "ZONOS_BENCH_DENSE", "ZONOS_BENCH_BUDGET_S", "ZONOS_BENCH_COMPONENTS"):
        os.environ.pop(var, None)
    if device == "cpu":
        os.environ["ZONOS_BENCH_PRESET"] = "tiny"
    wrappers = _kernel_wrappers()
    legs = {}

    def tap(name, fn):
        def leg(*args, **kwargs):
            for w in wrappers:
                w.launches = 0
            out = fn(*args, **kwargs)
            legs[name] = (out, {w.__name__: w.launches for w in wrappers})
            return out
        return leg

    saved = {name: getattr(bench, name) for name in (*BENCH_CUTS, *bench.LEGS)}
    for name, value in BENCH_CUTS.items():
        setattr(bench, name, value)
    for name in bench.LEGS:
        setattr(bench, name, tap(name, saved[name]))
    buf = io.StringIO()
    t = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = bench.main(["--device", device])
    finally:
        for name, value in saved.items():
            setattr(bench, name, value)
    seconds = time.perf_counter() - t
    out = buf.getvalue()
    print(out, end="", flush=True)
    lines = [line for line in out.splitlines() if line.startswith("{")]
    print(f"phase15 bench: exit {rc}, {seconds:.1f} s, card: {card}", flush=True)
    if rc != 0 or len(lines) != 1:
        _fail(f"phase 15: bench exit {rc}, {len(lines)} JSON lines")
    result = json.loads(lines[0])
    keys = ["metric", "value", "unit", "vs_baseline", "extra"]
    extra_keys = [*bench.EXTRA_KEYS, "card", "power_limit_w"]
    if list(result) != keys or list(result["extra"]) != extra_keys or result["metric"] != bench.METRIC:
        _fail(f"phase 15: the JSON line's keys {list(result)}, extra {list(result['extra'])}")
    numbers = {"value": result["value"], "vs_baseline": result["vs_baseline"],
               **{k: result["extra"][k] for k in bench.EXTRA_KEYS}}
    if device == "cuda":
        numbers["power_limit_w"] = result["extra"]["power_limit_w"]
    bad = {k: v for k, v in numbers.items() if not (isinstance(v, (int, float)) and np.isfinite(v) and v > 0)}
    if bad or not result["extra"]["card"]:
        _fail(f"phase 15: numbers not finite and > 0: {bad}; card {result['extra']['card']!r}")

    if device == "cuda":
        cfg, hcfg = C.zonos_v01_transformer_config(), C.zonos_v01_hybrid_config()
    else:
        cfg, hcfg = C.tiny_transformer_config(), C.tiny_hybrid_config()
    n_attn = len(hcfg.backbone.attn_layer_idx)
    total = {w.__name__: 0 for w in wrappers}
    for name in bench.LEGS:
        out_leg, counts = legs[name]
        for k, v in counts.items():
            total[k] += v
        steps = out_leg.get("decode_steps")
        prefills = len(steps) if steps else None
        if name == "engine":
            stats = out_leg["stats"]
            steps, prefills = [stats["steps"]], stats["prefills"]
            wavs = out_leg["wavs"]
            bad = [i for i, w in enumerate(wavs) if w.size == 0 or not np.isfinite(w).all()]
            print("phase15 engine requests:", json.dumps({"returned": len(wavs), "samples": [int(w.size) for w in wavs],
                                                          "stats": stats}), flush=True)
            if len(wavs) != BENCH_CUTS["ENGINE_REQUESTS"] or bad:
                _fail(f"phase 15: the engine returned {len(wavs)} requests, empty or non-finite PCM in {bad}")
        expected = None
        if name == "hybrid":
            expected = _expected_int8(steps, hcfg.backbone.n_layer, n_attn)
        elif steps is not None:
            expected = _expected_int8(steps, cfg.backbone.n_layer, prefills=prefills)
        print(f"phase15 {name} launches:", json.dumps(counts), "expected:", json.dumps(expected),
              "decode steps:", json.dumps(steps), "prefills:", prefills, flush=True)
        if device != "cuda":
            continue
        if expected is not None and counts != expected:
            _fail(f"phase 15 {name}: launch counts {counts} != expected {expected}")
        if expected is None and not all(counts[k] > 0 for k in ("int8_matmul", "attn_core_int8", "fused_mlp_int8")):
            _fail(f"phase 15 {name}: K1-K3 not all launched: {counts}")
    print(f"phase15 total: {seconds:.1f} s", flush=True)
    return {"bench": total}


def _phase_bench_main() -> int:
    """``--phase15``: phase 15 in a process of its own (started by
    ``_child_phase``). Prints the launch counts as its last line."""
    from zonos_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()  # built by the parent: finds every library
    counts = _phase_bench(_card_line())
    print(PHASE15_RESULT, json.dumps(counts), flush=True)
    return 0


# ---------------------------------------------------------------------------
# Phase 13: the sharded paths over nccl, one rank per card (four cards)
# ---------------------------------------------------------------------------

MC_WORLD = 4
MC_FRAMES, MC_PROFILE_FRAMES = 86, 16
MC_SEEDS = [11, 12, 13, 14]  # dp 4: one seed per row
MC_TRAIN_FRAMES = 256  # finetune_lora's default batch: 4 x 256 frames, samples of 192-256


def _mc_configs(device="cuda") -> dict:
    """Phase 13's models at full width and depth: the flagship (int8 and
    int4) and Zonos-v0.1-hybrid. On the CPU (a rehearsal) tiny configs with
    8 query and 4 KV heads, so that attention splits over tp 4."""
    from zonos_tpu_torch import config as C

    if torch.device(device).type == "cpu":
        def heads(cfg):
            attn = dataclasses.replace(cfg.backbone.attn_cfg, num_heads=8, num_heads_kv=4)
            return dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone, attn_cfg=attn))

        return {"int8": heads(C.tiny_transformer_config()), "int4": heads(C.tiny_transformer_config(d_model=512)),
                "hybrid": heads(C.tiny_hybrid_config())}
    t = C.zonos_v01_transformer_config()
    return {"int8": t, "int4": t, "hybrid": C.zonos_v01_hybrid_config()}


def _mc_model(name, cfg, device):
    """The seeded model of ``name`` (bf16 from seed 0, quantized), which every
    rank builds for itself on its card."""
    from zonos_tpu_torch.models.zonos import Zonos

    return Zonos.from_config(cfg, seed=0, dtype=torch.bfloat16, device=device).quantize(
        bits=4 if name == "int4" else 8).params


def _mc_train_batch(cfg, device):
    """Phase 11's full-step batch: 4 synthetic samples of 192-256 frames
    through ``build_batch`` (the model's conditioners, text through the
    native G2P) at 256 frames; on the CPU 4 samples of 18-24 at 24."""
    from zonos_tpu_torch.models.zonos import Zonos
    from zonos_tpu_torch.training.data import build_batch, synthetic_dataset

    frames = MC_TRAIN_FRAMES if torch.device(device).type == "cuda" else 24
    model = Zonos.from_config(cfg, seed=1, dtype=torch.float32, device=device)
    with torch.no_grad():
        return build_batch(model, synthetic_dataset(4, n_q=cfg.codebook_dimension, min_frames=frames * 3 // 4,
                                                    max_frames=frames, seed=3), frames=frames)


class _CollectiveCount:
    """Counts ``torch.distributed.all_reduce`` calls (every collective the
    sharded forward and train step issue: ``parallel.comm`` and
    ``training.train`` call it through the module)."""

    def __init__(self):
        import torch.distributed as dist

        self.n, inner = 0, dist.all_reduce

        def counted(*a, **k):
            self.n += 1
            return inner(*a, **k)

        dist.all_reduce = counted


def _mc_job(counter, params, cfg, cond, sampling, device, mesh, batch_size=1, seed=0):
    """A warm-up generate, then ``_decode_job`` with the collectives counted;
    also this rank's own rows before the dp gather (``_all_rows``' input)."""
    from zonos_tpu_torch.runtime import generate as G

    _decode_job(params, cfg, cond, WARM_FRAMES, sampling, device, mesh=mesh, batch_size=batch_size, seed=seed)
    own, gather = [], G._all_rows
    G._all_rows = lambda out, lengths, m: (own.append(out), gather(out, lengths, m))[1]
    counter.n = 0
    try:
        codes, logits, stats, counts = _decode_job(params, cfg, cond, MC_FRAMES, sampling, device, mesh=mesh,
                                                   batch_size=batch_size, seed=seed)
    finally:
        G._all_rows = gather
    return {"codes": codes, "own_rows": own[0], "logits": logits, "stats": stats,
            "counts": counts, "collectives": counter.n,
            "ms_per_frame": stats["decode_s"] * 1e3 / stats["decode_steps"]}


def _mc_infer(counter, tp, dp, dptp, refs):
    """The inference cases of a phase 13 rank: tp 4 on int8 (greedy with
    teacher forcing and first logits, then min-p), int4 and the hybrid
    (greedy with teacher forcing); dp 4 (min-p, a seed per row) with the
    one-device B 1 run of this rank's row; dp 2 x tp 2 at B 4 (greedy with
    teacher forcing of this dp index's rows of the one-device B 4 run)."""
    from zonos_tpu_torch.ops.sampling import SamplingParams
    from zonos_tpu_torch.parallel.mesh import batch_rows, shard_params
    from zonos_tpu_torch.runtime.generate import _cfg_rows

    dev = tp.device
    greedy, min_p = SamplingParams(temperature=0.0), SamplingParams(min_p=0.1)
    out, kept = {}, None
    for name, cfg in _mc_configs(dev).items():
        full = _mc_model(name, cfg, dev)
        d = cfg.backbone.d_model
        cond = _par_cond(d)
        if name == "int8":
            cond4 = _par_cond(d, b=4, seed=3)
            res = _mc_job(counter, full, cfg, cond4, min_p, dev, mesh=dp, batch_size=4, seed=MC_SEEDS)
            rows = batch_rows(dp, 4)
            ref = _decode_job(full, cfg, _cfg_rows(cond4, rows, 4), MC_FRAMES, min_p, dev,
                              seed=MC_SEEDS[rows.start:rows.stop])
            res.update(rows=(rows.start, rows.stop), ref=ref[0], ref_ms_per_frame=ref[2]["decode_s"] * 1e3
                       / ref[2]["decode_steps"])
            out["dp4"] = res
            local = shard_params(dptp, cfg, full)
            res = _mc_job(counter, local, cfg, cond4, greedy, dev, mesh=dptp, batch_size=4)
            rows = batch_rows(dptp, 4)
            res["forced"] = _forced_agreement(local, cfg, _cfg_rows(cond4, rows, 4), refs["dp2xtp2"]["codes"][rows],
                                              dev, mesh=dptp)
            res["rows"] = (rows.start, rows.stop)
            out["dp2xtp2"] = res
            del local
        local = shard_params(tp, cfg, full)
        del full
        res = _mc_job(counter, local, cfg, cond, greedy, dev, mesh=tp)
        res["corr"] = _corr(res.pop("logits"), refs[name]["logits"])
        res["forced"] = _forced_agreement(local, cfg, cond, refs[name]["codes"], dev, mesh=tp)
        if name == "int8":
            res["min_p"] = _mc_job(counter, local, cfg, cond, min_p, dev, mesh=tp, seed=7)
            kept = (local, cfg, cond)  # profiled last
        out[f"tp4_{name}"] = res
        del local
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        if tp.rank == 0:
            print(f"phase13 rank 0: {name} done", flush=True)
    return out, kept


def _mc_train(meshes, batch, steps=3):
    """The sharded train step at full depth, f32 with TF32 off, on each mesh
    of ``meshes`` ({name: mesh}): the first loss and this rank's gradients
    against one device's ``value_and_grad`` on the same weights and batch
    (computed once, on this rank's card), then ``steps`` AdamW steps (warmup
    1) with seconds per step, targets per second and the card's peak GB."""
    from zonos_tpu_torch.models.zonos import Zonos
    from zonos_tpu_torch.parallel.mesh import local_config, shard_params, shard_tree
    from zonos_tpu_torch.training import train as T

    dev = next(iter(meshes.values())).device
    cfg = _mc_configs(dev)["int8"]
    m = Zonos.from_config(cfg, seed=1, dtype=torch.float32, device=dev)
    params = {k: m.params[k] for k in ("embeddings", "heads", "backbone")}
    del m
    cond, codes, mask = batch
    t = time.perf_counter()
    loss1, g1 = T.value_and_grad(lambda c, dc, mk: T.loss_terms(params, cfg, c, dc, mk), T.trainable_leaves(params),
                                 1, cond, codes, mask)
    loss1 = float(loss1)
    one_s = time.perf_counter() - t
    names = [p for p, t_ in T.named_leaves(params) if t_.is_floating_point()]
    g1 = _tree_of(params, names, g1)
    targets = T.count_targets(codes, mask, cfg.head_vocab_size)
    out = {}
    for key, mesh in meshes.items():
        want = dict(T.named_leaves(shard_tree(cfg, g1, mesh.tp, mesh.tp_rank)))
        local = shard_params(mesh, cfg, params)
        lcfg = local_config(cfg, mesh.tp)
        loss, g = T.sharded_value_and_grad(
            mesh, lambda c, dc, mk: T.loss_terms(local, lcfg, c, dc, mk, mesh=mesh), T.trainable_leaves(local), 1,
            *T.shard_batch(mesh, cond, codes, mask))
        lnames = [p for p, t_ in T.named_leaves(local) if t_.is_floating_point()]
        cos = {p: _cos(a, want[p]) for p, a in zip(lnames, g)}
        out[key] = {"loss": float(loss), "loss_one_device": loss1, "loss_rel": abs(float(loss) - loss1) / abs(loss1),
                    "grad_cos_min": min(cos.values()), "grad_cos_argmin": min(cos, key=cos.get),
                    "leaves_compared": len(cos), "one_device_grad_s": one_s, "targets": targets}
        del g, want, local
    del g1
    for key, mesh in meshes.items():
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        state, step = T.make_sharded_train_step(mesh, cfg, T.make_optimizer(lr=1e-4, warmup=1), params)
        local_batch = T.shard_batch(mesh, cond, codes, mask)
        losses, secs = [], []
        for _ in range(steps):
            t = time.perf_counter()
            state, lo = step(state, *local_batch)
            losses.append(float(lo))  # syncs
            secs.append(time.perf_counter() - t)
        steady = float(np.median(secs[1:]))
        # the card's peak holds the whole model's f32 params too, which make_sharded_train_step shards
        out[key].update(losses=losses, s_per_step=secs, steady_s_per_step=steady, targets_per_s=targets / steady,
                        peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else None)
        del state, step
        if mesh.rank == 0:
            print(f"phase13 rank 0: train {key} done", flush=True)
    return out


# the profiler's span over each collective ("nccl:all_reduce"), not a kernel
NCCL_ANNOTATION = "nccl:"


def _mc_profile(mesh, kept) -> dict | None:
    """A short tp 4 int8 generate on every rank, under torch.profiler on
    rank 0 only (last in that rank: the profiler raises host cost per op for
    the rest of its process): nccl's device time and kernels per step beside
    all kernels' device time."""
    from torch.profiler import ProfilerActivity, profile

    from zonos_tpu_torch.ops.sampling import SamplingParams

    local, cfg, cond = kept
    greedy = SamplingParams(temperature=0.0)
    run = lambda: _decode_job(local, cfg, cond, MC_PROFILE_FRAMES, greedy, mesh.device, mesh=mesh)  # noqa: E731
    run()
    if mesh.rank != 0:
        run()
        return None
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _codes, _logits, stats, _counts = run()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith(NCCL_ANNOTATION)]
    steps = stats["decode_steps"] + 1  # the prefill counted as one more step
    nccl = [e for e in kernels if e.key.startswith("nccl")]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if device_ms == 0:
        return {"frames": MC_PROFILE_FRAMES, "nccl_device_ms_per_step": "not measured (the profiler saw no kernels)"}
    return {"frames": MC_PROFILE_FRAMES, "steps_with_prefill": steps,
            "nccl_device_ms_per_step": sum(e.self_device_time_total for e in nccl) / 1e3 / steps,
            "nccl_kernels_per_step": sum(e.count for e in nccl) / steps,
            "nccl_kernels": sorted({e.key[:60] for e in nccl}),
            "device_ms_per_step": device_ms / steps, "device_busy_ms_per_step": _busy_ms(prof) / steps,
            "kernel_launches_per_step": sum(e.count for e in kernels) / steps,
            "wall_ms_per_frame_profiled": stats["decode_s"] * 1e3 / stats["decode_steps"]}


def _mc_allreduce_us(mesh, calls: int = 200) -> dict:
    """Host µs per all-reduce over the tp group of a decode step's partials
    ([2, 1, 2048] f32), issued back to back (one sync at the end) and each
    followed by a sync."""
    import torch.distributed as dist

    from zonos_tpu_torch.runtime.generate import _sync

    x = torch.ones((2, 1, 2048), device=mesh.device)
    out = {}
    for key, sync in (("back_to_back", False), ("synced", True)):
        for _ in range(10):
            dist.all_reduce(x, group=mesh.tp_group)
        _sync(mesh.device)
        t = time.perf_counter()
        for _ in range(calls):
            dist.all_reduce(x, group=mesh.tp_group)
            if sync:
                _sync(mesh.device)
        _sync(mesh.device)
        out[key] = (time.perf_counter() - t) / calls * 1e6
    return out


def _mc_rank(backend, device, refs, batch):
    """A rank of phase 13's group (4 ranks, one per card): the inference
    cases, the train steps, then the profile."""
    from zonos_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counter = _CollectiveCount()
    tp = make_mesh(dp=1, tp=4, backend=backend, device=device)
    dp = make_mesh(dp=4, tp=1, backend=backend, device=device)
    dptp = make_mesh(dp=2, tp=2, backend=backend, device=device)
    dev = tp.device
    out = {"rank": tp.rank, "device": str(dev),
           "card": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    with torch.no_grad():
        infer, kept = _mc_infer(counter, tp, dp, dptp, refs)
    out.update(infer)
    out["allreduce_us"] = _mc_allreduce_us(tp)
    out["train"] = _mc_train({"dp2xtp2": dptp, "dp1xtp4": tp}, batch)
    with torch.no_grad():
        out["profile"] = _mc_profile(tp, kept)
    return out


def _mc_refs(device="cuda") -> tuple[dict, dict]:
    """The one-device runs on ``device`` (card 0), before the ranks start:
    greedy B 1 on each model (codes and first logits, and the noise floor of
    teacher forcing along those codes: the agreement of the same model at
    B 2 of that one row, whose kernels sum in another order), greedy and
    min-p (a seed per row) B 4 on int8. Returns (refs, ms per frame)."""
    from zonos_tpu_torch.ops.sampling import SamplingParams

    greedy, min_p = SamplingParams(temperature=0.0), SamplingParams(min_p=0.1)
    refs, one = {}, {}
    with torch.no_grad():
        for name, cfg in _mc_configs(device).items():
            params = _mc_model(name, cfg, device)
            cond = _par_cond(cfg.backbone.d_model)
            jobs = [(name, cond, greedy, 1, 0)]
            if name == "int8":
                cond4 = _par_cond(cfg.backbone.d_model, b=4, seed=3)
                jobs += [("dp2xtp2", cond4, greedy, 4, 0), ("dp4", cond4, min_p, 4, MC_SEEDS)]
            for key, c, sampling, b, seed in jobs:
                _decode_job(params, cfg, c, WARM_FRAMES, sampling, device, batch_size=b, seed=seed)
                codes, logits, stats, _ = _decode_job(params, cfg, c, MC_FRAMES, sampling, device, batch_size=b,
                                                      seed=seed)
                refs[key] = {"codes": codes, "logits": logits}
                one[key] = stats["decode_s"] * 1e3 / stats["decode_steps"]
            two = np.concatenate([cond[:1], cond[:1], cond[1:], cond[1:]])  # [c, c | u, u]
            refs[name]["floor"] = _forced_agreement(params, cfg, two, np.concatenate([refs[name]["codes"]] * 2),
                                                    device)["share"]
            del params
    return refs, one


def _mc_check(results: list, refs: dict, one: dict, on_card: bool) -> dict:
    """Phase 13's gates over the ranks' results: prints one line per case,
    then fails naming every gate missed. Returns the launch counts of rank 0
    per path. ``on_card`` False (a CPU rehearsal): no kernel launches are
    expected."""
    cfgs = _mc_configs("cuda" if on_card else "cpu")
    counts_by_path, failed = {}, []

    def want_counts(cfg, steps, bits=8):
        L, n_attn = cfg.backbone.n_layer, len(cfg.backbone.attn_layer_idx)
        if bits == 4:  # in_proj, out_proj, fc1, fc2 on K4; the heads (int8) on K1
            want = {"int8_matmul": steps + 1, "attn_core_int8": steps * n_attn, "fused_mlp_int8": 0,
                    "fused_mlp_int8_split": 0, "int4_matmul": steps * 4 * L}
        else:  # in_proj + out_proj per layer and the heads on K1 (and the prefill's heads), K3 per MLP
            want = {"int8_matmul": steps * (2 * L + 1) + 1, "attn_core_int8": steps * n_attn,
                    "fused_mlp_int8": steps * L, "fused_mlp_int8_split": 0, "int4_matmul": 0}
        return {k: v * on_card for k, v in want.items()}

    def collectives(cfg, steps, tp):
        """Per step and for the prefill: one all-reduce after each row-parallel
        product (out_proj and fc2 per layer, and per Mamba layer the gathered
        in_proj), and the tokens' check."""
        if tp == 1:
            return 0
        L, n_attn = cfg.backbone.n_layer, len(cfg.backbone.attn_layer_idx)
        return (steps + 1) * (2 * L + (L - n_attn if cfg.backbone.is_hybrid else 0) + 1)

    for name in ("int8", "int4", "hybrid"):
        cfg, key = cfgs[name], f"tp4_{name}"
        per = [r[key] for r in results]
        for p in per:
            steps = p["stats"]["decode_steps"]
            want = want_counts(cfg, steps, 4 if name == "int4" else 8)
            if p["counts"] != want:
                failed.append(f"phase 13: {key} launch counts {p['counts']} != expected {want}")
            if p["collectives"] != collectives(cfg, steps, 4):
                failed.append(f"phase 13: {key} collectives {p['collectives']} != {collectives(cfg, steps, 4)}")
            if p["codes"].shape != (1, cfg.codebook_dimension, MC_FRAMES) or \
                    not np.array_equal(p["own_rows"], per[0]["own_rows"]):
                failed.append(f"phase 13: {key}: the tp ranks' codes differ")
        if name == "int8" and not all(np.array_equal(p["min_p"]["codes"], per[0]["min_p"]["codes"]) for p in per):
            failed.append(f"phase 13: {key} min-p: the tp ranks' codes differ")
        steps = per[0]["stats"]["decode_steps"]
        res = {"frames": MC_FRAMES, "layers": cfg.backbone.n_layer, "first_logits_corr": min(p["corr"] for p in per),
               "forced_agreement": min(p["forced"]["share"] for p in per),
               "forced_compared": per[0]["forced"]["compared"],
               "greedy_equal_share": float(np.mean(per[0]["codes"] == refs[name]["codes"])),
               "ms_per_frame_tp4": [p["ms_per_frame"] for p in per], "ms_per_frame_one_device": one[name],
               "prefill_ms_tp4": [p["stats"]["prefill_s"] * 1e3 for p in per],
               "launches_per_step": {k: v / steps for k, v in per[0]["counts"].items() if v},
               "collectives_per_step": per[0]["collectives"] / (steps + 1)}
        if name == "int8":
            res["ms_per_frame_tp4_min_p"] = [p["min_p"]["ms_per_frame"] for p in per]
        # Agreement >= 90%, or within 2 points of the one-device floor where the
        # floor itself is lower: the full-depth hybrid's random weights give
        # near-tied picks that a B 2 run of the same row on one device already
        # moves below 90%. The logits correlation is gated on the flagship.
        res["one_device_floor"] = refs[name]["floor"]
        res["agreement_gate"] = min(0.90, refs[name]["floor"] - 0.02)
        print(f"phase13 tp4 {name}:", json.dumps(res), flush=True)
        if res["forced_agreement"] < res["agreement_gate"] or (name != "hybrid" and res["first_logits_corr"] < 0.999):
            failed.append(f"phase 13: tp 4 {name}: first-step logits corr {res['first_logits_corr']:.6f} (gate 0.999 "
                          f"on the flagship), teacher-forced agreement {res['forced_agreement']:.4f} (gate "
                          f"{res['agreement_gate']:.4f})")
        counts_by_path[key] = per[0]["counts"]

    cfg = cfgs["int8"]
    per = [r["dp4"] for r in results]
    for p in per:
        lo, hi = p["rows"]
        if p["codes"].shape != (4, cfg.codebook_dimension, MC_FRAMES) or not np.array_equal(p["codes"][lo:hi],
                                                                                          p["ref"]):
            failed.append(f"phase 13: dp 4 row {lo} differs from the one-device B 1 run of that row")
        if not np.array_equal(p["codes"], per[0]["codes"]) or p["collectives"] != 0:
            failed.append(f"phase 13: dp 4: the ranks returned different codes, or {p['collectives']} collectives ran")
        if p["counts"] != want_counts(cfg, p["stats"]["decode_steps"]):
            failed.append(f"phase 13: dp 4 launch counts {p['counts']}")
    counts_by_path["dp4"] = per[0]["counts"]
    print("phase13 dp4 int8 (B 4, a seed per row, 1 row per rank):", json.dumps({
        "rows_bit_equal": all(np.array_equal(p["codes"][slice(*p["rows"])], p["ref"]) for p in per),
        "ms_per_frame_dp4": [p["ms_per_frame"] for p in per],
        "ms_per_frame_one_device_b1": [p["ref_ms_per_frame"] for p in per],
        "ms_per_frame_one_device_b4": one["dp4"]}), flush=True)

    per = [r["dp2xtp2"] for r in results]
    for p in per:
        steps = p["stats"]["decode_steps"]
        if p["counts"] != want_counts(cfg, steps) or p["collectives"] != collectives(cfg, steps, 2):
            failed.append(f"phase 13: dp 2 x tp 2 launches {p['counts']}, collectives {p['collectives']}")
        if not np.array_equal(p["codes"], per[0]["codes"]) or p["codes"].shape != (4, cfg.codebook_dimension,
                                                                                  MC_FRAMES):
            failed.append("phase 13: dp 2 x tp 2: the ranks returned different codes")
    for dp_rank in range(2):  # the two tp ranks of each dp index
        a, b = per[2 * dp_rank], per[2 * dp_rank + 1]
        if a["rows"] != b["rows"] or not np.array_equal(a["own_rows"], b["own_rows"]):
            failed.append(f"phase 13: dp 2 x tp 2: the tp ranks of dp index {dp_rank} differ")
    res = {"forced_agreement": min(p["forced"]["share"] for p in per), "forced_compared": [p["forced"]["compared"]
                                                                                         for p in per],
           "greedy_equal_share": float(np.mean(per[0]["codes"] == refs["dp2xtp2"]["codes"])),
           "ms_per_frame": [p["ms_per_frame"] for p in per], "ms_per_frame_one_device_b4": one["dp2xtp2"],
           "collectives_per_step": per[0]["collectives"] / (per[0]["stats"]["decode_steps"] + 1)}
    print("phase13 dp2 x tp2 int8 (B 4, 2 rows per dp index):", json.dumps(res), flush=True)
    if res["forced_agreement"] < 0.90:
        failed.append(f"phase 13: dp 2 x tp 2 teacher-forced agreement {res['forced_agreement']:.4f} (gate 0.90)")
    counts_by_path["dp2xtp2"] = per[0]["counts"]

    for key in ("dp2xtp2", "dp1xtp4"):
        per = [r["train"][key] for r in results]
        res = {k: per[0][k] for k in ("loss", "loss_one_device", "losses", "targets", "leaves_compared")}
        res.update({"loss_rel": max(p["loss_rel"] for p in per), "grad_cos_min": min(p["grad_cos_min"] for p in per),
                    "grad_cos_argmin": min(per, key=lambda p: p["grad_cos_min"])["grad_cos_argmin"],
                    "s_per_step": [p["s_per_step"] for p in per],
                    "steady_s_per_step": [p["steady_s_per_step"] for p in per],
                    "targets_per_s": [p["targets_per_s"] for p in per], "peak_gb": [p["peak_gb"] for p in per],
                    "one_device_grad_s": [p["one_device_grad_s"] for p in per]})
        print(f"phase13 train {key} ({cfgs['int8'].backbone.n_layer} layers, f32, 4 x "
              f"{MC_TRAIN_FRAMES if on_card else 24} frames):",
              json.dumps(res), flush=True)
        losses = res["losses"]
        if res["loss_rel"] > 1e-5 or res["grad_cos_min"] < 0.99999:
            failed.append(f"phase 13: train {key}: loss {res['loss_rel']:.3g} relative, gradient cosine "
                  f"{res['grad_cos_min']:.8f} (gates 1e-5, 0.99999)")
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]) or any(p["losses"] != losses for p in per):
            failed.append(f"phase 13: train {key}: losses {[p['losses'] for p in per]} not finite, falling and equal")
    print("phase13 all-reduce of [2, 1, 2048] f32 over tp 4, host µs per call:",
          json.dumps([r["allreduce_us"] for r in results]), flush=True)
    print("phase13 profile (rank 0, tp 4 int8):", json.dumps(results[0]["profile"]), flush=True)
    if failed:
        _fail("; ".join(failed))
    return counts_by_path


def _card_lines() -> list:
    """``nvidia-smi --query-gpu=name,power.limit`` of every card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()


def _phase_multicard_main() -> int:
    """``--phase13``: tp 4, dp 4 and dp 2 x tp 2 generate and the dp 2 x
    tp 2 and dp 1 x tp 4 train steps over nccl, one rank per card, on four
    cards. Fewer cards raise: nothing falls back."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < MC_WORLD:
        raise RuntimeError(f"phase 13 needs {MC_WORLD} cards (one rank per card over nccl); {cards} visible")
    from zonos_tpu_torch.conditioning import native_g2p
    from zonos_tpu_torch.ops import _build
    from zonos_tpu_torch.parallel.mesh import spawn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    for i, line in enumerate(_card_lines()):
        print(f"card {i}: {line}", flush=True)
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda, "nccl": torch.cuda.nccl.version(),
                      "python": sys.version.split()[0]}), flush=True)
    g2p = threading.Thread(target=native_g2p.available)  # g++ beside the nvcc builds
    g2p.start()
    _build.build_all()
    g2p.join()
    print(f"phase13 build: {time.perf_counter() - t0:.1f} s", flush=True)
    t = time.perf_counter()
    refs, one = _mc_refs("cuda")
    batch = _mc_train_batch(_mc_configs()["int8"], "cuda")
    torch.cuda.empty_cache()
    print(f"phase13 one-device references on card 0: {time.perf_counter() - t:.1f} s; ms per frame",
          json.dumps(one), flush=True)
    t = time.perf_counter()
    results = spawn(_mc_rank, MC_WORLD, "nccl", "cuda", refs, batch, timeout=420)
    print(f"phase13 ranks (nccl, world {MC_WORLD}, one card each: "
          f"{[r['device'] + ' ' + r['card'] for r in results]}): {time.perf_counter() - t:.1f} s", flush=True)
    counts = _mc_check(results, refs, one, on_card=True)
    print(f"phase13 total: {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"launches_by_path": counts}), flush=True)
    for i, line in enumerate(_card_lines()):
        print(f"card {i}: {line}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# Phase 16: the serving fleet of docs/DEPLOYMENT.md (four cards)
# ---------------------------------------------------------------------------

FLEET_WORLD = 4
FLEET_SLOTS = 16  # ZONOS_MAX_BATCH of DEPLOYMENT.md's throughput mode: 32 decode rows with CFG
# SkyrimNet-like NPC lines of 1-4 s (86-340 frames at 2 + 6.5 per character)
FLEET_LINES = [
    "Stay awhile.", "Who goes there?", "Farewell, friend.", "The inn is warm tonight.",
    "Watch the road, traveler.", "The market opens at first light.", "I used to be an adventurer like you.",
    "Have you heard the news from Whiterun?", "Bring me three wolf pelts for the coin.",
    "Do not trust the merchant by the docks.", "My sword is yours, if the price is right.",
    "Snow falls on the pass, so travel at dawn.", "Keep your voice down, the walls have ears.",
    "The dragon was seen over the western hills.", "The guards at the gate will not let you pass.",
    "Wolves hunt near the frozen lake after dark, friend.",
]
# 880 characters: three chunks of at most 360 (serving/longform.py), 346, 280 and 252
FLEET_LONGFORM = (
    "The road to Whiterun runs north along the river, past the old watchtower and the farms where the "
    "Battle-Born family keeps its cattle. Travelers who leave at dawn reach the city gates before the "
    "midday bell, but those who linger at the inn find the pass closed by nightfall. The guards say a "
    "dragon was seen above the western hills three days ago. "
    "Since then no merchant has dared the mountain road without an escort. If you mean to go, take a "
    "torch, a warm cloak and enough bread for two days. The innkeeper sells salted meat and mead for a "
    "fair price, and she knows which caves along the way are safe when the snow comes down. "
    "Do not stray from the path after dark: wolves hunt in packs near the frozen lake, and the bandits "
    "at the ruined fort take whatever a lone traveler carries. When you reach the city, ask for the "
    "steward at the great hall, and tell him Riverwood sent you.")
FLEET_VOICE = "fleet_voice"
FLEET_REQUEST_S = 600.0  # every client call's timeout: one that runs out fails the phase
FLEET_START_S = 900.0  # a backend's start (checkpoint, int8, warm-up) and the router's


def _fleet_http(url: str, body=None, timeout: float = FLEET_REQUEST_S):
    """(status, headers, bytes) of one request; an error status is returned,
    a refused connection or a timeout raises."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _fleet_ok(url: str, body=None, timeout: float = FLEET_REQUEST_S) -> tuple[dict, bytes]:
    code, headers, data = _fleet_http(url, body, timeout)
    if code != 200:
        _fail(f"phase 16: {url} answered {code}: {data[:300]!r}")
    return headers, data


def _fleet_stream(base: str, body) -> tuple[float, bytes]:
    """Time to the first PCM bytes of a /stream and all its bytes."""
    import http.client
    import urllib.parse

    u = urllib.parse.urlparse(base)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=FLEET_REQUEST_S)
    try:
        t = time.perf_counter()
        conn.request("POST", "/stream", json.dumps(body))
        resp = conn.getresponse()
        if resp.status != 200 or resp.getheader("X-PCM-Format") != "s16le-mono":
            _fail(f"phase 16: {base}/stream answered {resp.status}: {resp.read()[:300]!r}")
        head = resp.read(2)
        ttfa = time.perf_counter() - t
        return ttfa, head + resp.read()
    finally:
        conn.close()


# every client thread of phase 16 joined within a request's timeout, or the phase fails
_fleet_threads = functools.partial(_parallel, timeout=FLEET_REQUEST_S + 60, phase="phase 16")


def _generate_200(base: str, body) -> dict:
    """One /generate that must answer 200 with a non-empty 44.1 kHz WAV."""
    t = time.perf_counter()
    headers, data = _fleet_ok(base + "/generate", body)
    rate, pcm = _wav(data)
    if rate != 44100 or pcm.size == 0:
        _fail(f"phase 16: {base}/generate gave {pcm.size} samples at {rate} Hz")
    return {"audio_s": pcm.size / rate, "wall_s": time.perf_counter() - t, "bytes": data,
            "meta": json.loads(headers.get("X-Zonos-Meta", "{}"))}


def _metric(page: str, series: str) -> float:
    for line in page.splitlines():
        if line.startswith(series + " "):
            return float(line.rsplit(" ", 1)[1])
    return 0.0


GENERATE_200 = 'zonos_requests_total{endpoint="/generate",status="200"}'


def _fleet_wide_paths(card: str, model, on_card: bool = True) -> dict:
    """Step 1 of phase 16, in this process: the 32-row paths of a server in
    throughput mode on one card. The continuous engine at 16 slots (16
    requests of 1-2 s at once, 2 more that join mid-epoch as slots free),
    then the same through an engine of 8 slots, each timed; the 16-slot
    engine's greedy codes against EngineReference (its decode at 32 rows);
    the dynamic batcher at max_batch 16 (16 requests in one generate_audio:
    bf16 KV, so K2 never launches). K1-K3 launch counts exact on every path
    (``on_card``)."""
    from zonos_tpu_torch.ops import cuda_attention as A
    from zonos_tpu_torch.ops import cuda_matmul as M
    from zonos_tpu_torch.serving.batcher import DynamicBatcher, TTSRequest
    from zonos_tpu_torch.serving.continuous import ContinuousEngine
    from zonos_tpu_torch.serving.pipeline import prepare_generation_params

    kernels = (M.int8_matmul, A.attn_core_int8, M.fused_mlp_int8)
    n_layer = model.config.backbone.n_layer

    def reset():
        for k in kernels:
            k.launches = 0

    def check(label, steps, prefills, k2=True):
        got = {k.__name__: k.launches for k in kernels}
        want = {"int8_matmul": steps * (2 * n_layer + 1) + prefills, "attn_core_int8": steps * n_layer if k2 else 0,
                "fused_mlp_int8": steps * n_layer}
        print(f"phase16 {label} launches:", json.dumps(got), "expected:", json.dumps(want), flush=True)
        if on_card and got != want:
            _fail(f"phase 16 {label}: launch counts {got} != expected {want}")
        return got

    def request(text, seed):
        n = prepare_generation_params(text, randomize_seed=False).max_new_tokens
        return TTSRequest(text=text, seed=seed, max_new_tokens=n)

    short = [t for t in FLEET_LINES if prepare_generation_params(t, randomize_seed=False).max_new_tokens <= 172]
    texts = [short[i % len(short)] for i in range(FLEET_SLOTS)]  # 1-2 s each
    result = {"card": card}

    def burst(eng):
        """16 requests at once, then 2 that queue once the epoch has run
        and join as slots free: (wall s, audio s, stats delta)."""
        late_reqs = [request(FLEET_LINES[i], 700 + i) for i in range(2)]
        late = []

        def join_late():
            t = time.perf_counter()
            while eng.stats["steps"] == before["steps"] and time.perf_counter() - t < 300:
                time.sleep(0.01)
            return _fleet_threads(eng.submit, [(r,) for r in late_reqs])

        with JoinTap() as joins:  # open before the warm-up: the burst may join the warm-up's epoch
            eng.submit(request(FLEET_LINES[0], 1))  # warm-up: the first epoch's one-time costs
            before = dict(eng.stats)
            reset()
            t = time.perf_counter()
            outs = _fleet_threads(lambda f, *a: f(*a), [(eng.submit, request(text, 600 + i)) for i, text in
                                                         enumerate(texts)] + [(lambda: late.extend(join_late()),)])
            wall = time.perf_counter() - t
        outs = outs[:-1] + late
        late_steps = [joins.of(r, model.device) for r in late_reqs]
        if len(outs) != FLEET_SLOTS + 2 or not all(w.size > 0 for w, _sr in outs) or min(late_steps) <= 0:
            _fail(f"phase 16: an engine of {eng.slots} slots answered {len(outs)} requests, or one was empty, "
                  f"or the late two joined at steps {late_steps}")
        delta = {k: eng.stats[k] - before[k] for k in before if isinstance(before[k], int)}
        delta["late_join_steps"] = late_steps
        return wall, sum(w.size / sr for w, sr in outs), delta

    for slots in (FLEET_SLOTS, FLEET_SLOTS // 2):
        eng = ContinuousEngine(model, slots=slots)
        try:
            wall, audio, delta = burst(eng)
            label = f"engine {slots} slots"
            counts = check(label, delta["steps"], delta["prefills"])
            if delta["requests"] != FLEET_SLOTS + 2 or delta["slot_recycles"] < 2:
                _fail(f"phase 16 {label}: {delta}: every request, 2 of them in recycled slots, expected")
            row = {"slots": slots, "rows": 2 * slots, "requests": delta["requests"], "steps": delta["steps"],
                   "prefills": delta["prefills"], "late_join_steps": delta["late_join_steps"],
                   "slot_recycles": delta["slot_recycles"], "wall_s": wall, "audio_s": audio,
                   "audio_s_per_wall_s": audio / wall, "ms_per_step": wall * 1e3 / max(delta["steps"], 1),
                   "launches": counts, "card": card}
            print(f"phase16 {label}:", json.dumps(row), flush=True)
            result[f"engine_{slots}"] = row
            if slots == FLEET_SLOTS:
                result["greedy_parity"] = _greedy_parity(model, eng, label="phase16")
        finally:
            eng.close()

    batcher = DynamicBatcher(model, max_batch=FLEET_SLOTS, window_ms=5000)  # forms once all 16 are in
    steps_log = []
    generate_audio = model.generate_audio

    def recorded(*args, **kw):
        stats = {}
        out = generate_audio(*args, stats=stats, **kw)
        steps_log.append(stats["decode_steps"])
        return out

    model.generate_audio = recorded
    reset()
    try:
        t = time.perf_counter()
        outs = _fleet_threads(lambda i: batcher.submit(request(texts[i], 800 + i)), [(i,) for i in range(FLEET_SLOTS)])
        wall = time.perf_counter() - t
        stats = dict(batcher.stats)
    finally:
        del model.generate_audio
        batcher.close()
    if stats["batches"] != 1 or stats["requests"] != FLEET_SLOTS or not all(w.size > 0 for w, _sr in outs):
        _fail(f"phase 16: the dynamic batcher at max_batch {FLEET_SLOTS}: {stats}, one batch of 16 expected")
    counts = check("dynamic batcher", sum(steps_log), len(steps_log), k2=False)
    result["batcher"] = {"stats": stats, "steps": sum(steps_log), "wall_s": wall, "launches": counts,
                         "audio_s_per_wall_s": sum(w.size / sr for w, sr in outs) / wall, "card": card}
    print("phase16 dynamic batcher:", json.dumps(result["batcher"]), flush=True)
    return result


def _compute_pids() -> dict:
    """pid -> card uuid of every compute process nvidia-smi lists."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,gpu_uuid", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    rows = [line.split(",") for line in out.strip().splitlines() if line.strip()]
    return {int(r[0]): r[1].strip() for r in rows if len(r) == 2 and r[0].strip().isdigit()}


def _memory_used() -> dict:
    """nvidia-smi's memory.used of every card in MiB, by index."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=index,memory.used", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    rows = [line.split(",") for line in out.strip().splitlines() if line.strip()]
    return {int(r[0]): float(r[1]) for r in rows}


def _card_nodes(pid: int) -> list:
    """The card device nodes (/dev/nvidia<N>) a process holds open: the
    cards it runs on, where nvidia-smi's pids are another namespace's."""
    import re

    nodes = set()
    for fd in os.listdir(f"/proc/{pid}/fd"):
        try:
            target = os.readlink(f"/proc/{pid}/fd/{fd}")
        except OSError:
            continue
        if re.fullmatch(r"/dev/nvidia\d+", target):
            nodes.add(target)
    return sorted(nodes)


def _server_cards(pids: list, devices: list, before: dict) -> dict:
    """Each server's card, by the first evidence that attributes it:
    nvidia-smi's compute apps (uuid by pid), else the one card device node
    each process holds open, else (nvidia-smi's pids in another namespace,
    every node open) the card's memory.used, risen by 1 GiB or more since
    before the servers started on every card of ``devices`` (each server
    was started with CUDA_VISIBLE_DEVICES of its own). Fails unless the
    servers are on as many distinct cards as ``devices`` names."""
    apps = _compute_pids()
    listed = {pid: apps.get(pid) for pid in pids}
    nodes = {pid: _card_nodes(pid) for pid in pids}
    after = _memory_used()
    print("phase16 nvidia-smi compute apps:", json.dumps(apps), "memory.used MiB before and after the start:",
          json.dumps(before), json.dumps(after), "servers' pids there:", json.dumps(listed),
          "servers' card nodes:", json.dumps(nodes), flush=True)
    n_cards = len(set(devices))
    if None not in listed.values():
        how, cards = "nvidia-smi compute apps", listed
    elif all(len(n) == 1 for n in nodes.values()):
        how, cards = "the card node each holds", {pid: n[0] for pid, n in nodes.items()}
    else:
        how, cards = "memory.used by CUDA_VISIBLE_DEVICES", {pid: f"card {d}" for pid, d in zip(pids, devices)}
        if any(after[d] - before[d] < 1024 for d in set(devices)):
            _fail(f"phase 16: memory.used {before} -> {after}: not every card of {sorted(set(devices))} took a server")
    print(f"phase16 servers' cards (by {how}):", json.dumps(cards), flush=True)
    if len(set(cards.values())) != n_cards:
        _fail(f"phase 16: the servers {cards} are not on {n_cards} distinct cards")
    return cards


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _log_tail(path: str, n: int = 30) -> str:
    with open(path, errors="replace") as f:
        return "".join(f.readlines()[-n:])


def _start_fleet(work: str, devices: list, env_extra: dict) -> dict:
    """One ``python -m zonos_tpu_torch.serving.server --warmup`` per entry of
    ``devices`` (its CUDA_VISIBLE_DEVICES), all at once in ``work``, then
    ``python -m zonos_tpu_torch.serving.router`` over them; returns once
    every backend answers /health and the router /router_stats."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k not in ("ZONOS_CONTINUOUS", "ZONOS_PLATFORM", "ZONOS_TINY_MODEL")}
    env.update(env_extra, PYTHONPATH=os.pathsep.join(p for p in (repo, os.environ.get("PYTHONPATH")) if p))
    fleet = {"procs": [], "logs": [], "urls": [], "start_s": []}
    t0 = time.perf_counter()
    for i, dev in enumerate(devices):
        port = _free_port()
        log = os.path.join(work, f"backend{i}.log")
        env_i = dict(env, ZONOS_BATCHING="1", ZONOS_MAX_BATCH=str(FLEET_SLOTS))
        if dev is not None:
            env_i["CUDA_VISIBLE_DEVICES"] = str(dev)
        with open(log, "w") as f:
            fleet["procs"].append(subprocess.Popen(
                [sys.executable, "-m", "zonos_tpu_torch.serving.server", "--server", "127.0.0.1", "--port", str(port),
                 "--warmup"], cwd=work, env=env_i, stdout=f, stderr=subprocess.STDOUT))
        fleet["logs"].append(log)
        fleet["urls"].append(f"http://127.0.0.1:{port}")
    pending = set(range(len(devices)))
    starts = [None] * len(devices)
    while pending:
        for i in sorted(pending):
            if fleet["procs"][i].poll() is not None:
                _fail(f"phase 16: backend {i} exited {fleet['procs'][i].returncode}:\n{_log_tail(fleet['logs'][i])}")
            try:
                if _fleet_http(fleet["urls"][i] + "/health", timeout=2)[0] == 200:
                    starts[i] = time.perf_counter() - t0
                    pending.discard(i)
            except OSError:
                pass
        if time.perf_counter() - t0 > FLEET_START_S:
            _fail(f"phase 16: backends {sorted(pending)} did not listen within {FLEET_START_S:.0f} s")
        time.sleep(0.5)
    fleet["start_s"] = starts
    rport = _free_port()
    fleet["router_log"] = os.path.join(work, "router.log")
    with open(fleet["router_log"], "w") as f:
        fleet["router"] = subprocess.Popen(
            [sys.executable, "-m", "zonos_tpu_torch.serving.router", "--port", str(rport), "--cooldown", "3600",
             *[a for u in fleet["urls"] for a in ("--backend", u)]], cwd=work, env=env, stdout=f,
            stderr=subprocess.STDOUT)
    fleet["router_url"] = f"http://127.0.0.1:{rport}"
    t = time.perf_counter()
    while True:
        try:
            if _fleet_http(fleet["router_url"] + "/router_stats", timeout=2)[0] == 200:
                break
        except OSError:
            pass
        if fleet["router"].poll() is not None or time.perf_counter() - t > 120:
            _fail(f"phase 16: the router did not listen:\n{_log_tail(fleet['router_log'])}")
        time.sleep(0.2)
    return fleet


def _stop_fleet(fleet: dict) -> list:
    """SIGTERM to the router and every backend still running, SIGKILL after
    60 s; returns their pids."""
    procs = [p for p in [fleet.get("router"), *fleet.get("procs", [])] if p is not None]
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=60)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=60)
    return [p.pid for p in procs]


def _fleet(card: str, work: str, devices: list, env_extra: dict, n_burst: int = 64, n_kill: int = 32,
           longform_text: str = FLEET_LONGFORM, on_card: bool = True) -> dict:
    """Steps 2-6 of phase 16: the servers and the router as processes in one
    working directory, every check through the router; see main()'s
    docstring. ``devices`` gives each backend's CUDA_VISIBLE_DEVICES (None:
    the parent's); ``on_card`` adds the checks of nvidia-smi."""
    from zonos_tpu_torch.audio.io import write_wav
    from zonos_tpu_torch.serving import longform
    from zonos_tpu_torch.serving.router import aggregate_metrics

    result = {"card": card, "backends": len(devices)}
    fleet = {}
    try:
        before = _memory_used() if on_card else {}
        fleet = _start_fleet(work, devices, env_extra)
        urls, front = fleet["urls"], fleet["router_url"]
        result["backend_start_s"] = fleet["start_s"]
        print("phase16 backends started (checkpoint load, int8, warm-up; s):", json.dumps(fleet["start_s"]),
              f"card: {card}", flush=True)
        if on_card:
            result["server_cards"] = list(_server_cards([p.pid for p in fleet["procs"]], devices, before).values())

        # 3. through the router: health, the admin broadcast
        health = json.loads(_fleet_ok(front + "/health")[1])
        stats = json.loads(_fleet_ok(front + "/router_stats")[1])
        if health != {"status": "ok"} or [b["healthy"] for b in stats["backends"]] != [True] * len(urls):
            _fail(f"phase 16: router health {health}, stats {stats}")
        import base64

        write_wav(os.path.join(work, "voice.wav"), _voice(10.0, 24000, seed=31), 24000)
        with open(os.path.join(work, "voice.wav"), "rb") as f:
            voice_b64 = base64.b64encode(f.read()).decode()
        upload = json.loads(_fleet_ok(front + "/speakers", {"name": FLEET_VOICE, "wav_base64": voice_b64})[1])
        lexicon = json.loads(_fleet_ok(front + "/lexicon", {"entries": {"Riverwood": "ˈɹɪvɚwʊd"}})[1])
        listed = [json.loads(_fleet_ok(u + "/speakers")[1])["speakers"] for u in urls]
        if upload["backends_ok"] != len(urls) or lexicon["backends_ok"] != len(urls) or \
                not all(f"uploads/{FLEET_VOICE}" in s for s in listed):
            _fail(f"phase 16: the broadcast reached {upload}, {lexicon}; speakers {listed}")
        speaker = upload["results"][0]["speaker"]

        # the same fixed-seed request to each backend in turn, bit-equal: backend
        # 0 embeds the uploaded voice into the shared cache, the others read it
        fixed = {"text": FLEET_LINES[4], "seed": 4242, "randomize_seed": False, "speaker": speaker}
        per_backend = [_generate_200(u, fixed) for u in urls]
        same = [r["bytes"] == per_backend[0]["bytes"] for r in per_backend]
        print("phase16 one fixed-seed request on each backend, bit-equal to backend 0's:", same, flush=True)
        if not all(same) or not all(r["meta"].get("batched") for r in per_backend):
            _fail(f"phase 16: the fixed-seed request differs across backends: {same}")

        # the burst through the router, and the same work on backend 0 alone
        def served():
            return [_metric(_fleet_ok(u + "/metrics")[1].decode(), GENERATE_200) for u in urls]

        before = served()
        bodies = [{"text": FLEET_LINES[i % len(FLEET_LINES)], "seed": 1000 + i, "randomize_seed": False,
                   "speaker": speaker} for i in range(n_burst)]
        t = time.perf_counter()
        burst = _fleet_threads(lambda b: _generate_200(front, b), [(b,) for b in bodies])
        burst_s = time.perf_counter() - t
        per = [a - b for a, b in zip(served(), before)]
        fleet_rate = sum(r["audio_s"] for r in burst) / burst_s
        n_alone = n_burst // len(urls)
        t = time.perf_counter()
        alone = _fleet_threads(lambda b: _generate_200(urls[0], b), [(b,) for b in bodies[:n_alone]])
        alone_s = time.perf_counter() - t
        alone_rate = sum(r["audio_s"] for r in alone) / alone_s
        result["burst"] = {"requests": n_burst, "wall_s": burst_s, "audio_s": sum(r["audio_s"] for r in burst),
                           "audio_s_per_wall_s": fleet_rate, "served_per_backend": per,
                           "backend0_alone": {"requests": n_alone, "wall_s": alone_s, "audio_s_per_wall_s": alone_rate},
                           "fleet_over_one_backend": fleet_rate / alone_rate, "host_cpus": os.cpu_count(),
                           "host_load_1m": os.getloadavg()[0], "card": card}
        print("phase16 burst through the router:", json.dumps(result["burst"]), flush=True)
        if sum(per) != n_burst or min(per) < n_burst // (2 * len(urls)):
            _fail(f"phase 16: the router spread {n_burst} requests as {per}")

        # /stream through the router against the same request direct, in turns
        # (an inline voice: the servers store it under cache/uploads/)
        write_wav(os.path.join(work, "inline.wav"), _voice(6.0, 24000, seed=32), 24000)
        with open(os.path.join(work, "inline.wav"), "rb") as f:
            inline_b64 = base64.b64encode(f.read()).decode()
        sbody = {"text": FLEET_LINES[6], "seed": 77, "randomize_seed": False, "speaker_wav_base64": inline_b64}
        turns = [_fleet_stream(base, sbody) for base in (front, urls[0], front, urls[0])]
        result["stream"] = {"ttfa_router_s": [turns[0][0], turns[2][0]], "ttfa_direct_s": [turns[1][0], turns[3][0]],
                            "bytes": len(turns[0][1]), "equal": all(t[1] == turns[1][1] for t in turns), "card": card}
        print("phase16 /stream through the router and direct, in turns:", json.dumps(result["stream"]), flush=True)
        if not result["stream"]["equal"] or not turns[0][1]:
            _fail(f"phase 16: /stream through the router and direct differ: {[len(t[1]) for t in turns]} bytes")

        # a long-form request to /generate and /stream, through the router and direct, all at once
        chunks = longform.chunk_text(longform_text)
        lbody = {"text": longform_text, "seed": 91, "randomize_seed": False, "speaker": speaker}
        t = time.perf_counter()
        via_router = {}
        routed = [threading.Thread(target=lambda: via_router.update(generate=_generate_200(front, lbody)), daemon=True),
                  threading.Thread(target=lambda: via_router.update(stream=_fleet_stream(front, lbody)[1]), daemon=True)]
        for th in routed:
            th.start()
        while True:  # the direct pair goes to the backends the router left idle
            busy = [b["outstanding"] for b in json.loads(_fleet_ok(front + "/router_stats")[1])["backends"]]
            if sum(busy) >= 2 or not any(th.is_alive() for th in routed) or time.perf_counter() - t > 60:
                break
            time.sleep(0.05)
        idle = [u for u, n in zip(urls, busy) if n == 0] + list(reversed(urls))
        gen_d, stream_d = _fleet_threads(lambda f: f(), [(lambda: _generate_200(idle[0], lbody),),
                                                         (lambda: _fleet_stream(idle[1], lbody)[1],)],
                                         timeout=2 * FLEET_REQUEST_S)
        for th in routed:
            th.join(timeout=2 * FLEET_REQUEST_S)
        if any(th.is_alive() for th in routed) or set(via_router) != {"generate", "stream"}:
            _fail(f"phase 16: the long-form requests through the router did not both answer: {sorted(via_router)}")
        lf_s = time.perf_counter() - t
        gen_r, stream_r = via_router["generate"], via_router["stream"]
        floor = (len(chunks) - 1) * int(longform.CHUNK_GAP_S * 44100) + len(chunks) * 512  # the gaps, a frame a chunk
        samples = _wav(gen_r["bytes"])[1].size
        result["longform"] = {"chars": len(longform_text), "chunks": len(chunks), "audio_s": gen_r["audio_s"],
                              "stream_bytes": len(stream_r), "wall_s": lf_s, "generate_equal": gen_r["bytes"] ==
                              gen_d["bytes"], "stream_equal": stream_r == stream_d, "card": card}
        print("phase16 long-form through the router and direct:", json.dumps(result["longform"]), flush=True)
        if len(chunks) < 2 or samples < floor or len(stream_r) // 2 < floor or gen_r["bytes"] != gen_d["bytes"] \
                or stream_r != stream_d:
            _fail(f"phase 16: long-form {result['longform']}, {samples} samples against a floor of {floor}")
        paths = [gen_r["meta"].get("path"), gen_d["meta"].get("path")]

        # the router's /metrics: the sum of the backends' pages, read with no traffic between
        def series(page: str) -> dict:
            return {line.rpartition(" ")[0]: line.rpartition(" ")[2] for line in page.splitlines()
                    if line and not line.startswith("#") and 'endpoint="/metrics"' not in line}

        for attempt in range(5):
            pages = [_fleet_ok(u + "/metrics")[1].decode() for u in urls]
            fleet_page = _fleet_ok(front + "/metrics")[1].decode()
            again = [_fleet_ok(u + "/metrics")[1].decode() for u in urls]
            if [series(p) for p in pages] == [series(p) for p in again]:  # no request still being counted
                break
            time.sleep(1.0)
        want, got = series(aggregate_metrics(pages)), series(fleet_page)
        differ = sorted(k for k in want.keys() | got.keys() if want.get(k) != got.get(k))
        print(f"phase16 router /metrics against aggregate_metrics of the backends' pages: {len(got)} series, "
              f"{len(differ)} differ (a page's own /metrics series left out: each read counts itself)", flush=True)
        if differ or not got:
            _fail(f"phase 16: the router's /metrics differs from the backends' sum on {differ[:5]}")

        # 4. a second burst; backend 3 SIGKILLed while it has requests in flight
        dead = urls[-1]
        killed = {}

        def killer():
            t = time.perf_counter()
            while time.perf_counter() - t < FLEET_REQUEST_S:
                st = json.loads(_fleet_http(front + "/router_stats", timeout=10)[2])
                if any(b["url"] == dead and b["outstanding"] > 0 for b in st["backends"]):
                    fleet["procs"][-1].kill()
                    killed.update(outstanding=[b["outstanding"] for b in st["backends"] if b["url"] == dead][0],
                                  after_s=time.perf_counter() - t)
                    return
                time.sleep(0.05)

        kbodies = [{"text": FLEET_LINES[i % len(FLEET_LINES)], "seed": 2000 + i, "randomize_seed": False,
                    "speaker": speaker} for i in range(n_kill)]
        watch = threading.Thread(target=killer, daemon=True)
        watch.start()
        answers = _fleet_threads(lambda b: _fleet_http(front + "/generate", b), [(b,) for b in kbodies])
        watch.join(timeout=60)
        failed = [(code, data[:200].decode(errors="replace")) for code, _h, data in answers if code != 200]
        ok = [_wav(data)[1].size for code, _h, data in answers if code == 200]
        stats = json.loads(_fleet_ok(front + "/router_stats")[1])
        health = {b["url"]: b["healthy"] for b in stats["backends"]}
        result["backend_death"] = {"requests": n_kill, "killed_with_outstanding": killed.get("outstanding"),
                                   "succeeded": len(ok), "failed": len(failed), "healthy": list(health.values()),
                                   "card": card}
        print("phase16 backend 3 killed mid-burst:", json.dumps(result["backend_death"]), flush=True)
        if not killed or not all(code == 502 and dead in msg for code, msg in failed) or not all(n > 0 for n in ok) \
                or health[dead] or not all(v for u, v in health.items() if u != dead):
            _fail(f"phase 16: after the kill: failed {failed[:4]}, healthy {health}, killed {killed}")

        # 6. shutdown, then what the servers left in their shared directory (5.)
        pids = _stop_fleet(fleet)
        if on_card:
            t = time.perf_counter()
            while set(pids) & set(_compute_pids()) and time.perf_counter() - t < 60:
                time.sleep(1.0)
            left = sorted(set(pids) & set(_compute_pids()))
            alive = [pid for pid in pids if os.path.exists(f"/proc/{pid}")]
            print("phase16 after the shutdown: nvidia-smi memory.used", json.dumps(_memory_used()),
                  "compute apps", json.dumps(_compute_pids()), flush=True)
            if left or alive:
                _fail(f"phase 16: after the shutdown nvidia-smi lists {left}, processes {alive} remain")
        import glob
        import wave

        embeds = glob.glob(os.path.join(work, "cache", "embeds", "**", "*.npz"), recursive=True)
        uploads = glob.glob(os.path.join(work, "cache", "uploads", "*.wav")) + \
            glob.glob(os.path.join(work, "speakers", "uploads", "*.wav"))
        for path in embeds:
            if not np.isfinite(np.load(path)["data"]).all():
                _fail(f"phase 16: {path} holds non-finite values")
        for path in uploads:
            with wave.open(path) as w:
                w.readframes(w.getnframes())
        temps = [os.path.relpath(os.path.join(d, f), work) for d, _s, fs in os.walk(work) for f in fs if ".tmp" in f]
        outputs = sorted(os.listdir(os.path.join(work, "output_temp")))
        result["shared_dir"] = {"embeds": len(embeds), "uploads": len(uploads), "temporaries": temps,
                                "output_dirs": outputs, "wav_paths": paths}
        print("phase16 shared working directory:", json.dumps(result["shared_dir"]), flush=True)
        if not embeds or len(uploads) < 2 or temps or None in paths or len(set(paths)) != len(paths):
            _fail(f"phase 16: the shared directory: {result['shared_dir']}")
    finally:
        if fleet:
            _stop_fleet(fleet)
    return result


PHASE16_EXTRA = "--rehearse-on-one-card"


def _phase_fleet_main(one_card: bool = False) -> int:
    """``--phase16``: the fleet of docs/DEPLOYMENT.md on four cards (step 1 on
    card 0 in this process, then four servers and the router as processes).
    Fewer cards raise. With ``--rehearse-on-one-card`` every backend shares
    card 0: the same checks on a one-card machine, nvidia-smi's naming one card."""
    need = 1 if one_card else FLEET_WORLD
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < need:
        raise RuntimeError(f"phase 16 needs {need} cards (one server per card); {cards} visible")
    from zonos_tpu_torch.conditioning import native_g2p
    from zonos_tpu_torch.config import zonos_v01_transformer_config
    from zonos_tpu_torch.models.zonos import Zonos
    from zonos_tpu_torch.ops import _build
    from zonos_tpu_torch.serving.app_config import DEFAULT_CONFIG
    from zonos_tpu_torch.utils.export import save_reference_checkpoint

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    for i, line in enumerate(_card_lines()):
        print(f"card {i}: {line}", flush=True)
    card = _card_line()
    g2p = threading.Thread(target=native_g2p.available)  # g++ beside the nvcc builds: the servers find both built
    g2p.start()
    _build.build_all()
    g2p.join()
    if not native_g2p.available():
        _fail("phase 16: the native G2P library did not build")
    print(f"phase16 build: {time.perf_counter() - t0:.1f} s", flush=True)
    with tempfile.TemporaryDirectory() as work:
        ckpt = os.path.join(work, "checkpoint")
        t = time.perf_counter()
        seeded = Zonos.from_config(zonos_v01_transformer_config(), seed=0, dtype=torch.bfloat16, device="cuda")
        save_reference_checkpoint(ckpt, seeded.params, seeded.config)
        with open(os.path.join(work, "configmodel.txt"), "w") as f:  # complete: no server appends to it
            for k, v in {**DEFAULT_CONFIG, "PATH_MODEL_TRANSFORMER": ckpt}.items():
                f.write(f"{k} = {v}\n")
        print(f"phase16 flagship written as a reference checkpoint: {time.perf_counter() - t:.1f} s", flush=True)
        wide = _fleet_wide_paths(card, seeded.quantize())
        del seeded
        torch.cuda.empty_cache()
        devices = [0] * FLEET_WORLD if one_card else list(range(FLEET_WORLD))
        result = _fleet(card, work, devices, {})
    print(f"phase16 total: {time.perf_counter() - t0:.1f} s", flush=True)
    print("phase16 result:", json.dumps({"wide_paths": {k: v for k, v in wide.items() if k != "greedy_parity"},
                                         **result}), flush=True)
    for i, line in enumerate(_card_lines()):
        print(f"card {i}: {line}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


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
                   if e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith(NCCL_ANNOTATION))
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
    _two_thread_check(gen)
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
    # last in this process: once torch.profiler has run, host cost per op stays raised in it
    _phase_profile("int8", model, cond, result["decode_ms_per_frame"])
    _phase_profile("int4", model4, cond4, result4["decode_ms_per_frame"])
    _phase_profile("hybrid int8", model_h, cond_h, result_h["decode_ms_per_frame"])
    del model, model4, model_h
    torch.cuda.empty_cache()
    server_counts = _child_phase(10, [repr(result["rtf"])], PHASE10_RESULT)
    train_counts = _child_phase(11, [], PHASE11_RESULT)
    par_counts = _child_phase(12, [], PHASE12_RESULT)
    command_counts = _child_phase(14, [], PHASE14_RESULT)
    bench_counts = _child_phase(15, [], PHASE15_RESULT)

    by_path = {"int8": counts, "int4": facade_counts, "hybrid_int8": hybrid_counts, "server": server_counts,
               **train_counts, **par_counts, **command_counts, **bench_counts}

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
              [k3["K3"], k3["K3 hybrid"], k3["K3 tp2"], k3["K3 tp4"]], counts["fused_mlp_int8"]),
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
    print(f"phase13: not run by this run; it runs as `python3 chip_smoke.py --phase13` on a machine with "
          f"{MC_WORLD} cards (one rank per card over nccl); this one sees {torch.cuda.device_count()}", flush=True)
    print(f"phase16: not run by this run; it runs as `python3 chip_smoke.py --phase16` on a machine with "
          f"{FLEET_WORLD} cards (one server per card behind serving/router.py); this one sees "
          f"{torch.cuda.device_count()}", flush=True)
    print(f"card: {_card_line()}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--parts"] and torch.cuda.is_available():
        sys.exit(_kernel_parts())
    if sys.argv[1:] == ["--pair-streams"] and torch.cuda.is_available():
        sys.exit(_pair_streams())
    if sys.argv[1:2] == ["--phase10"] and torch.cuda.is_available():
        sys.exit(_phase_server_main(float(sys.argv[2])))
    if sys.argv[1:] == ["--phase11"] and torch.cuda.is_available():
        sys.exit(_phase_train_main())
    if sys.argv[1:] == ["--phase12"] and torch.cuda.is_available():
        sys.exit(_phase_parallel_main())
    if sys.argv[1:] == ["--phase14"] and torch.cuda.is_available():
        sys.exit(_phase_commands_main())
    if sys.argv[1:] == ["--phase15"] and torch.cuda.is_available():
        sys.exit(_phase_bench_main())
    if sys.argv[1:] == ["--phase13"]:
        sys.exit(_phase_multicard_main())
    if sys.argv[1:2] == ["--phase16"] and sys.argv[2:] in ([], [PHASE16_EXTRA]):
        sys.exit(_phase_fleet_main(one_card=sys.argv[2:] == [PHASE16_EXTRA]))
    sys.exit(main())
