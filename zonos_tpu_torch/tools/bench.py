"""The benchmark: the main path's speed in one JSON line (the port's
counterpart of ``bench.py``).

    python -m zonos_tpu_torch.tools.bench [--device cpu]

``bench.py``'s recipe on the port: the flagship transformer from seed 0 at
full width, int8 weights and int8 KV cache (``ZONOS_BENCH_DENSE=1``: bf16
unquantized), conditioning [2, 80, 2048] x 0.05 from ``default_rng(0)``, cfg
2.0, min-p 0.1, EOS forbidden, 10 s requests, each timed leg after one
warm-up call:

  * ``value``: RTF of the 10 s request through
    ``runtime/streaming.generate_audio`` (the DAC pipelined behind the decode
    loop, int16 PCM), mean of 3 runs; ``vs_baseline`` against
    ``BASELINE_RTF``;
  * ``extra.rtf_e2e_sequential_10s``, ``extra.decode_ms_per_frame``:
    ``runtime/generate.generate``, then ``DACAutoencoder.decode``;
  * ``extra.ttfa_p50_ms``: time to the first chunk of ``generate_stream``
    (first chunk 12 frames), median of 3;
  * ``extra.rtf_aggregate_batch8``: 8 requests in one ``generate`` + decode;
  * ``extra.rtf_engine_sustained``: ``serving/continuous.ContinuousEngine``
    (8 slots) under 24 text requests of 5 s arriving 0.25 s apart;
  * ``extra.rtf_e2e_hybrid_10s``: the 10 s request on Zonos-v0.1-hybrid;
  * ``extra.card``, ``extra.power_limit_w``: what ``nvidia-smi`` reads.

``ZONOS_BENCH_PRESET=tiny`` runs the tiny configurations at f32 with a tiny
DAC, 24 frames. ``ZONOS_BENCH_BUDGET_S`` (default 2400) skips a later leg,
leaving it null with a line on stderr, once too little time is left. A leg
that raises ends the run with exit 1 after its traceback, and no JSON line.
``ZONOS_BENCH_COMPONENTS=1`` also prints the sequential and pipelined legs'
seconds. It runs on the card unless ``--device`` names another device; every
clock read follows a device sync.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
import traceback

import numpy as np
import torch

BASELINE_RTF = 2.0  # reference README.md:131 (RTX 4090)
SECONDS = 10.0
FRAMES_PER_SEC = 86  # reference app_constants.py:7
METRIC = "rtf_e2e_transformer_10s_1chip"
EXTRA_KEYS = ("rtf_e2e_sequential_10s", "decode_ms_per_frame", "ttfa_p50_ms", "rtf_aggregate_batch8",
              "rtf_engine_sustained", "rtf_e2e_hybrid_10s")
LC = 80  # conditioning prefix length (phonemes + controls)
COND_SCALE = 0.05
N_RUNS = 3  # timed runs of the sequential and pipelined legs
TTFA_RUNS = 3
FIRST_CHUNK_FRAMES, CHUNK_FRAMES = 12, 86  # the TTFA leg's stream
BATCH = 8
HYBRID_RUNS = 2
ENGINE_SLOTS, ENGINE_WINDOW_MS = 8, 50.0
ENGINE_PAD_BUCKET = 32  # the server's phoneme bucket (serving/server.py)
ENGINE_SECONDS = 5.0  # each sustained request's length
ENGINE_REQUESTS, ENGINE_INTERVAL_S = 24, 0.25
ENGINE_WARM_BURST = 8  # warm-up: a burst at once, then a staggered stream
ENGINE_WARM_REQUESTS, ENGINE_WARM_INTERVAL_S = 12, 0.2
ENGINE_TIMEOUT_S = 1800.0
BUDGET_S = 2400.0
LEFT_S = {"ttfa": 300.0, "batch8": 420.0, "engine": 480.0, "hybrid": 600.0}  # time a leg needs left
TINY_FRAMES = 24
TINY_ENGINE_WARM_REQUESTS, TINY_ENGINE_REQUESTS = 4, 6
TINY_DAC = dict(encoder_hidden_size=8, downsampling_ratios=(2, 4), decoder_hidden_size=32,
                upsampling_ratios=(4, 2), n_codebooks=9, codebook_size=1024, codebook_dim=4, hidden_size=24)
TINY_FRAME_BUCKET = 8
LEGS = ("sequential", "pipelined", "ttfa", "batch8", "engine", "hybrid")


def draw_cond(rng: np.random.Generator, d: int, batch_size: int = 1) -> np.ndarray:
    """Conditioning [2B, LC, d] (cond ++ uncond): ``bench.py``'s N(0, 1) x 0.05 draw."""
    return rng.normal(size=(2 * batch_size, LC, d)).astype(np.float32) * COND_SCALE


def _now(device: torch.device) -> float:
    """The clock, read once the device has finished what was queued."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _generate(model, cond, *, frames, sampling, kv_int8, seed, steps: list, batch_size: int = 1):
    """One ``runtime/generate.generate`` call of the recipe; appends its decode steps to ``steps``."""
    from zonos_tpu_torch.runtime import generate as G

    stats: dict = {}
    codes = G.generate(model.params, model.config, cond, max_new_tokens=frames, cfg_scale=2.0,
                       batch_size=batch_size, sampling_params=sampling, seed=seed, dtype=model.dtype,
                       forbid_eos=True, kv_int8=kv_int8, device=model.device, stats=stats)
    steps.append(stats["decode_steps"])
    return codes


def _generate_then_decode(model, ae, cond, *, frames, runs, dac_runs, sampling, kv_int8) -> dict:
    """Generate, then a whole-request DAC decode, after a warm-up of both:
    the mean seconds of ``runs`` generates and of ``dac_runs`` decodes of the
    last codes, and the RTF of their sum."""
    dev, steps = model.device, []
    kw = dict(frames=frames, sampling=sampling, kv_int8=kv_int8, steps=steps)
    ae.decode(_generate(model, cond, seed=1, **kw))
    t0 = _now(dev)
    for i in range(runs):
        codes = _generate(model, cond, seed=2 + i, **kw)
    t_gen = (_now(dev) - t0) / runs
    t0 = _now(dev)
    for _ in range(dac_runs):
        wav = ae.decode(codes)
    t_dac = (_now(dev) - t0) / dac_runs
    audio_s = codes.shape[-1] / FRAMES_PER_SEC
    return {"rtf": audio_s / (t_gen + t_dac), "decode_ms_per_frame": t_gen / codes.shape[-1] * 1e3,
            "t_gen": t_gen, "t_dac": t_dac, "audio_s": audio_s, "codes": codes, "wav": wav, "decode_steps": steps}


def sequential(model, ae, cond, *, frames, runs, sampling, kv_int8) -> dict:
    """Generate, then a whole-request DAC decode (``bench.py:143-168``), each
    timed over ``runs``: RTF and decode ms per frame."""
    return _generate_then_decode(model, ae, cond, frames=frames, runs=runs, dac_runs=runs, sampling=sampling,
                                 kv_int8=kv_int8)


def pipelined(model, ae, cond, *, frames, runs, sampling, kv_int8, pcm_int16) -> dict:
    """``runtime/streaming.generate_audio``, the DAC behind the decode loop
    (``bench.py:170-190``): RTF over ``runs`` timed runs after a warm-up."""
    from zonos_tpu_torch.runtime.streaming import generate_audio

    dev, steps, stats = model.device, [], {}

    def run(seed):
        out = generate_audio(model.params, model.config, cond, autoencoder=ae, max_new_tokens=frames,
                             cfg_scale=2.0, batch_size=1, sampling_params=sampling, seed=seed, dtype=model.dtype,
                             forbid_eos=True, kv_int8=kv_int8, pcm_int16=pcm_int16, device=dev, stats=stats)
        steps.append(stats["decode_steps"])
        return out

    run(1)
    t0 = _now(dev)
    for i in range(runs):
        wav, lengths = run(2 + i)
    t_pipe = (_now(dev) - t0) / runs
    return {"rtf": float(np.max(lengths)) / FRAMES_PER_SEC / t_pipe, "t_pipe": t_pipe, "wav": wav,
            "lengths": lengths, "decode_steps": steps, "stats": stats}


def ttfa(model, ae, cond, *, frames, runs, sampling, kv_int8) -> dict:
    """Seconds to the first chunk of ``generate_stream`` (first chunk
    ``FIRST_CHUNK_FRAMES``, then ``CHUNK_FRAMES``; ``bench.py:206-227``):
    the median of ``runs`` after a warm-up."""
    from zonos_tpu_torch.runtime.streaming import generate_stream

    dev = model.device

    def first_audio(seed):
        t0 = _now(dev)
        gen = generate_stream(model.params, model.config, cond, autoencoder=ae, max_new_tokens=frames,
                              cfg_scale=2.0, sampling_params=sampling, seed=seed,
                              first_chunk_frames=FIRST_CHUNK_FRAMES, chunk_frames=CHUNK_FRAMES, dtype=model.dtype,
                              forbid_eos=True, kv_int8=kv_int8, device=dev)
        pcm, _sr = next(gen)
        dt = _now(dev) - t0
        gen.close()
        if pcm.size == 0 or not np.isfinite(pcm).all():
            raise RuntimeError(f"ttfa: the first chunk holds {pcm.size} samples, finite {np.isfinite(pcm).all()}")
        return dt

    first_audio(1)
    ts = sorted(first_audio(2 + i) for i in range(runs))
    return {"ttfa_ms": ts[len(ts) // 2] * 1e3, "ttfa_s": ts}


def batch8(model, ae, cond8, *, frames, sampling, kv_int8) -> dict:
    """``BATCH`` requests in one ``generate``, then one DAC decode of them all
    (``bench.py:229-245``): aggregate RTF of one timed run after a warm-up."""
    dev, steps = model.device, []
    b = cond8.shape[0] // 2
    kw = dict(frames=frames, sampling=sampling, kv_int8=kv_int8, steps=steps, batch_size=b)
    ae.decode(_generate(model, cond8, seed=1, **kw))
    t0 = _now(dev)
    codes = _generate(model, cond8, seed=2, **kw)
    wav = ae.decode(codes)
    t8 = _now(dev) - t0
    return {"rtf": b * codes.shape[-1] / FRAMES_PER_SEC / t8, "t": t8, "codes": codes, "wav": wav,
            "decode_steps": steps}


def engine(model, ae, *, frames, requests, warm_requests) -> dict:
    """The continuous engine under sustained staggered load
    (``bench.py:247-302``): ``ENGINE_SLOTS`` slots, a warm-up burst of
    ``ENGINE_WARM_BURST`` and a warm-up stream of ``warm_requests``, then
    ``requests`` text requests of ``frames`` frames arriving
    ``ENGINE_INTERVAL_S`` apart. Audio seconds received per wall second of
    the timed stream (random weights may end a request early). The phoneme
    bucket is the server's while the engine runs, and restored after."""
    from zonos_tpu_torch.conditioning import text as _text
    from zonos_tpu_torch.serving.batcher import TTSRequest
    from zonos_tpu_torch.serving.continuous import ContinuousEngine

    bucket = _text.PAD_BUCKET
    _text.PAD_BUCKET = ENGINE_PAD_BUCKET
    model._autoencoder = ae
    eng = None
    try:
        eng = ContinuousEngine(model, slots=ENGINE_SLOTS, window_ms=ENGINE_WINDOW_MS)

        def load(n, interval):
            out, errors = {}, []

            def sub(i):
                time.sleep(i * interval)
                try:
                    out[i] = eng.submit(TTSRequest(
                        text=f"benchmark request number {i}, a sentence of moderate length.",
                        max_new_tokens=frames, seed=1), timeout=ENGINE_TIMEOUT_S)
                except BaseException as e:  # noqa: BLE001  re-raised below, in the caller's thread
                    errors.append(e)

            threads = [threading.Thread(target=sub, args=(i,)) for i in range(n)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            dt = _now(model.device) - t0
            if errors:
                raise errors[0]
            return out, dt

        load(ENGINE_WARM_BURST, 0.0)
        load(warm_requests, ENGINE_WARM_INTERVAL_S)
        res, dt = load(requests, ENGINE_INTERVAL_S)
        audio_s = sum(w.shape[0] / sr for w, sr in res.values())
        sys.stderr.write(f"# engine stats: {eng.stats}\n")
        return {"rtf": audio_s / dt, "t": dt, "audio_s": audio_s, "wavs": [res[i][0] for i in range(requests)],
                "stats": dict(eng.stats)}
    finally:
        if eng is not None:
            eng.close()
        _text.PAD_BUCKET = bucket


def hybrid(hmodel, ae, hcond, *, frames, runs, sampling, kv_int8) -> dict:
    """The sequential request on the hybrid backbone (``bench.py:304-335``):
    ``runs`` timed generates, one timed DAC decode."""
    return _generate_then_decode(hmodel, ae, hcond, frames=frames, runs=runs, dac_runs=1, sampling=sampling,
                                 kv_int8=kv_int8)


def card_info(device: torch.device) -> tuple[str, float | None]:
    """The card's name and power limit in W (``nvidia-smi``); ("cpu", None) on the CPU."""
    if device.type != "cuda":
        return "cpu", None
    from zonos_tpu_torch.utils.sysinfo import nvidia_smi

    index = torch.cuda.current_device() if device.index is None else device.index
    lines = nvidia_smi("name,power.limit")
    name, _, limit = (lines[index] if index < len(lines) else "").rpartition(", ")
    try:
        return name, float(limit.split()[0])
    except (IndexError, ValueError):
        return torch.cuda.get_device_name(device), None


def run(device: torch.device, tiny: bool = False, dense: bool = False, budget_s: float = BUDGET_S,
        components: bool = False) -> dict:
    """The whole recipe on ``device``; returns the JSON line's object."""
    from zonos_tpu_torch.codec.dac import DACAutoencoder, init_dac_params
    from zonos_tpu_torch.config import (DACConfig, tiny_hybrid_config, tiny_transformer_config,
                                        zonos_v01_hybrid_config, zonos_v01_transformer_config)
    from zonos_tpu_torch.models.zonos import Zonos
    from zonos_tpu_torch.ops.sampling import SamplingParams
    from zonos_tpu_torch.utils.compile_cache import enable as enable_compile_cache

    t_wall0 = time.monotonic()

    def left() -> float:
        return budget_s - (time.monotonic() - t_wall0)

    def skip(leg: str) -> bool:
        if tiny or left() > LEFT_S[leg]:
            return False
        sys.stderr.write(f"# {leg} leg skipped: {left():.0f} s of the {budget_s:.0f} s budget left, "
                         f"it needs {LEFT_S[leg]:.0f}\n")
        return True

    enable_compile_cache(device)
    dtype = torch.float32 if tiny else torch.bfloat16
    cfg = tiny_transformer_config() if tiny else zonos_v01_transformer_config()
    model = Zonos.from_config(cfg, seed=0, dtype=dtype, device=device)
    if not dense:
        model = model.quantize()
    if tiny:
        dcfg = DACConfig(**TINY_DAC)
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        ae = DACAutoencoder(params=init_dac_params(gen, dcfg, device=device), cfg=dcfg, dtype=dtype,
                            frame_bucket=TINY_FRAME_BUCKET, device=device)
    else:
        ae = DACAutoencoder(dtype=dtype, device=device)

    frames = TINY_FRAMES if tiny else int(SECONDS * FRAMES_PER_SEC)
    rng = np.random.default_rng(0)
    cond = draw_cond(rng, cfg.backbone.d_model)
    recipe = dict(frames=frames, sampling=SamplingParams(min_p=0.1), kv_int8=not dense)

    seq = sequential(model, ae, cond, runs=N_RUNS, **recipe)
    pipe = pipelined(model, ae, cond, runs=N_RUNS, pcm_int16=not dense, **recipe)
    card, power = card_info(device)
    extra = {**dict.fromkeys(EXTRA_KEYS), "card": card, "power_limit_w": power}
    extra["rtf_e2e_sequential_10s"] = round(seq["rtf"], 3)
    extra["decode_ms_per_frame"] = round(seq["decode_ms_per_frame"], 3)
    if components:
        last = pipe["stats"]  # the last pipelined run's prefill, decode segments and DAC pieces
        print(f"# t_gen={seq['t_gen']:.3f}s t_dac={seq['t_dac']:.3f}s t_pipe={pipe['t_pipe']:.3f}s "
              f"(prefill {last['prefill_s']:.3f}s, segments {last['segments_s']:.3f}s, dac {last['dac_s']:.3f}s) "
              f"audio={seq['audio_s']:.2f}s", flush=True)
    if not skip("ttfa"):
        extra["ttfa_p50_ms"] = round(ttfa(model, ae, cond, runs=TTFA_RUNS, **recipe)["ttfa_ms"], 1)
    if not skip("batch8"):
        cond8 = draw_cond(rng, cfg.backbone.d_model, BATCH)
        extra["rtf_aggregate_batch8"] = round(batch8(model, ae, cond8, **recipe)["rtf"], 3)
    if not skip("engine"):
        eng = engine(model, ae, frames=TINY_FRAMES if tiny else int(ENGINE_SECONDS * FRAMES_PER_SEC),
                     requests=TINY_ENGINE_REQUESTS if tiny else ENGINE_REQUESTS,
                     warm_requests=TINY_ENGINE_WARM_REQUESTS if tiny else ENGINE_WARM_REQUESTS)
        extra["rtf_engine_sustained"] = round(eng["rtf"], 3)
    if not skip("hybrid"):
        del model
        if device.type == "cuda":
            torch.cuda.empty_cache()
        hcfg = tiny_hybrid_config() if tiny else zonos_v01_hybrid_config()
        hmodel = Zonos.from_config(hcfg, seed=0, dtype=dtype, device=device)
        if not dense:
            hmodel = hmodel.quantize()
        hcond = draw_cond(rng, hcfg.backbone.d_model)
        extra["rtf_e2e_hybrid_10s"] = round(hybrid(hmodel, ae, hcond, runs=HYBRID_RUNS, **recipe)["rtf"], 3)

    rtf = pipe["rtf"]
    return {"metric": METRIC, "value": round(rtf, 3), "unit": "x_realtime",
            "vs_baseline": round(rtf / BASELINE_RTF, 3), "extra": extra}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", help="torch device (default: the card; raises without one)")
    args = ap.parse_args(argv)
    from zonos_tpu_torch import resolve_device

    device = resolve_device(args.device)
    try:
        with torch.no_grad():
            result = run(device, tiny=os.environ.get("ZONOS_BENCH_PRESET") == "tiny",
                         dense=os.environ.get("ZONOS_BENCH_DENSE") == "1",
                         budget_s=float(os.environ.get("ZONOS_BENCH_BUDGET_S", BUDGET_S)),
                         components=os.environ.get("ZONOS_BENCH_COMPONENTS") == "1")
    except Exception:
        traceback.print_exc()
        sys.stderr.write("# bench failed: a leg raised; no result\n")
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
