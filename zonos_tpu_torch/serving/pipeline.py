"""Generation pipeline: request params → conditioning → codes → wav file
(port of ``zonos_tpu/serving/pipeline.py``).

``prepare_generation_params`` (seed handling and the text-length → token
budget heuristic), speaker and prefix audio set-up, ``generate_and_save_audio``
with per-request RTF logging, the long-form chunk plan and ``tts``, the
one-call request of the server, on the port's ``Zonos`` facade. The speaker
tower runs on the model's device. The environment switches are the JAX
package's, with the same defaults: ``ZONOS_PCM_INT16`` (int16 PCM quantized
on the device, default on) and ``ZONOS_LONGFORM_CONTINUITY`` (continue each
long-form chunk from the last codes of the one before, default off).
"""

from __future__ import annotations

import itertools
import logging
import math
import os
import random
import time
from dataclasses import dataclass, field

import numpy as np

from zonos_tpu_torch.audio.io import write_wav
from zonos_tpu_torch.conditioning.cond_dict import make_cond_dict
from zonos_tpu_torch.serving import constants as C
from zonos_tpu_torch.serving import longform
from zonos_tpu_torch.serving.audio_prep import process_prefix_audio, process_speaker_audio
from zonos_tpu_torch.serving.caches import get_output_dir
from zonos_tpu_torch.utils import profiling

logger = logging.getLogger("zonos_tpu_torch")

_OUTPUT_SEQ = itertools.count()


def new_output_path() -> str:
    """A new wav path in this process's output directory:
    ``zonos_<ms>_<n>.wav``, n counting this process's requests, so that two
    requests in one millisecond (or two processes, whose directories differ)
    never share a file. JAX's pipeline names it ``zonos_<ms>.wav``."""
    return os.path.join(get_output_dir(), f"zonos_{time.time_ns() // 1_000_000}_{next(_OUTPUT_SEQ)}.wav")


@dataclass
class GenerationParams:
    seed: int
    max_new_tokens: int
    cfg_scale: float = 2.0
    sampling: dict = field(default_factory=lambda: {"min_p": 0.1})


def prepare_generation_params(
    text: str,
    seed: int = C.DEFAULT_SEED,
    randomize_seed: bool = True,
    cfg_scale: float = 2.0,
    min_p: float = 0.1,
    linear: float = 0.0,
    conf: float = 0.0,
    quad: float = 0.0,
) -> GenerationParams:
    """Seed handling + token budget:
    max_new_tokens = clamp(86, 2 + ceil(len(text) * 6.5), 2580)."""
    if randomize_seed:
        seed = random.randint(C.SEED_MIN, C.SEED_MAX)
    est = C.TOKEN_SAFETY_MARGIN + math.ceil(len(text) * C.TEXT_TO_TOKENS_MULTIPLIER)
    max_new = max(C.MIN_NEW_TOKENS, min(est, C.MAX_NEW_TOKENS_CEILING))
    sampling = {"min_p": min_p}
    if linear > 0:
        sampling = {"linear": linear, "conf": conf, "quad": quad, "min_p": 0.0}
    return GenerationParams(seed=int(seed), max_new_tokens=max_new, cfg_scale=cfg_scale, sampling=sampling)


def setup_speaker_conditioning(
    model_name: str,
    speaker_audio_path: str | None,
    use_cache: bool = True,
    device=None,
) -> np.ndarray | None:
    if not speaker_audio_path:
        return None
    with profiling.span("pipeline.speaker"):
        return process_speaker_audio(speaker_audio_path, model_name, use_cache=use_cache, device=device)


def setup_prefix_audio(prefix_audio_path: str | None, autoencoder, use_cache: bool = True):
    if not prefix_audio_path:
        return None
    with profiling.span("pipeline.prefix"):
        return process_prefix_audio(prefix_audio_path, autoencoder, use_cache=use_cache)


def _generate_wave(model, cond_dict, params, audio_prefix_codes, use_cond_cache, stats):
    """conditioning → pipelined generate + DAC; returns (wav [T], n_tokens).

    ``model.generate_audio`` runs the DAC on settled code spans while the
    decode loop is still going (same tokens and lengths as ``generate`` +
    ``decode``).
    """
    with profiling.span("pipeline.conditioning"):
        conditioning = model.prepare_conditioning(cond_dict, use_cache=use_cond_cache, cfg_scale=params.cfg_scale)
    wav, lengths = model.generate_audio(
        conditioning,
        audio_prefix_codes=audio_prefix_codes,
        max_new_tokens=params.max_new_tokens,
        cfg_scale=params.cfg_scale,
        sampling_params=params.sampling,
        seed=params.seed,
        # The request's terminal format is a 16-bit wav; quantizing on the
        # device halves the PCM readback (ZONOS_PCM_INT16=0 reads back
        # float32 and quantizes on the host).
        pcm_int16=os.environ.get("ZONOS_PCM_INT16", "1") != "0",
        stats=stats,
    )
    return wav[0], int(lengths[0])


def generate_and_save_audio(
    model,
    cond_dict: dict,
    params: GenerationParams,
    audio_prefix_codes: np.ndarray | None = None,
    output_path: str | None = None,
    use_cond_cache: bool = True,
    stats: dict | None = None,
) -> tuple[str, np.ndarray, int, float]:
    """Full request: conditioning → generate → DAC decode → wav file.

    Returns (wav_path, waveform [T], sample_rate, rtf). A ``stats`` dict
    receives ``generate_audio``'s timings and step count.
    """
    t_start = time.perf_counter_ns()
    wav, n_tokens = _generate_wave(model, cond_dict, params, audio_prefix_codes, use_cond_cache, stats)
    sr = model.autoencoder.sampling_rate

    if output_path is None:
        output_path = new_output_path()
    with profiling.span("pipeline.write_wav"):
        write_wav(output_path, wav, sr)

    wall_s = (time.perf_counter_ns() - t_start) / 1e9
    audio_s = wav.shape[-1] / sr
    rtf = audio_s / wall_s if wall_s > 0 else 0.0
    logger.info(
        f"generated {audio_s:.2f}s audio in {wall_s:.2f}s "
        f"({rtf:.2f}x realtime, seed={params.seed}, tokens={n_tokens})"
    )
    return output_path, wav, sr, rtf


def plan_chunks(text: str, params: GenerationParams, cfg_scale: float, min_p: float):
    """Long-form chunk plan: one (chunk, per-chunk params) pair per chunk —
    the seed advances per chunk and the token budget is re-estimated from the
    chunk's own length. A single entry for short text."""
    if not longform.is_longform(text):
        return [(text, params)]
    return [
        (
            chunk,
            prepare_generation_params(
                chunk, seed=params.seed + i, randomize_seed=False, cfg_scale=cfg_scale, min_p=min_p,
            ),
        )
        for i, chunk in enumerate(longform.chunk_text(text))
    ]


def build_cond_dict(
    model,
    text: str,
    language: str = "en-us",
    speaker: np.ndarray | None = None,
    emotion: list | None = None,
    fmax: float = 22050.0,
    pitch_std: float = 20.0,
    speaking_rate: float = 15.0,
    vqscore_8: list | None = None,
    ctc_loss: float = 0.0,
    dnsmos_ovrl: float = 4.0,
    speaker_noised: bool = False,
    unconditional_keys=frozenset({"vqscore_8", "dnsmos_ovrl"}),
) -> dict:
    """Full-control-surface cond dict, filtered to the model's conditioners."""
    cond = make_cond_dict(
        text=text,
        language=language,
        speaker=speaker,
        emotion=list(emotion) if emotion is not None else list(C.DEFAULT_EMOTION),
        fmax=fmax,
        pitch_std=pitch_std,
        speaking_rate=speaking_rate,
        vqscore_8=list(vqscore_8) if vqscore_8 is not None else [0.78] * 8,
        ctc_loss=ctc_loss,
        dnsmos_ovrl=dnsmos_ovrl,
        speaker_noised=speaker_noised,
        unconditional_keys=unconditional_keys,
    )
    known = set(model.conditioner_names)
    return {k: v for k, v in cond.items() if k in known}


def _generate_longform(model, text, params, prefix_codes, cond_kw, cfg_scale, min_p, output_path):
    """Sentence chunks generated one after another and joined (with a short
    gap, or continued from the previous chunk's last codes when
    ``ZONOS_LONGFORM_CONTINUITY=1``) into one wav file."""
    t_start = time.perf_counter_ns()
    chunks = plan_chunks(text, params, cfg_scale, min_p)
    sr = model.autoencoder.sampling_rate
    gap = np.zeros(int(longform.CHUNK_GAP_S * sr), dtype=np.float32)
    # generate() keeps an audio prefix verbatim at the start of its output,
    # so a continued chunk's prefix frames are trimmed before the decode.
    continuity = os.environ.get("ZONOS_LONGFORM_CONTINUITY") == "1"
    tail_frames = 43  # ~0.5 s at 86 frames/s
    waves: list[np.ndarray] = []
    total_tokens = 0
    prev_tail: np.ndarray | None = None
    for i, (chunk, params_i) in enumerate(chunks):
        cond_i = build_cond_dict(model, text=chunk, **cond_kw)
        # The caller's audio prefix seeds the FIRST chunk; later chunks
        # continue from the previous chunk's tail when enabled.
        prefix_i = prefix_codes if i == 0 else prev_tail
        conditioning = model.prepare_conditioning(cond_i, use_cache=True, cfg_scale=params_i.cfg_scale)
        codes = model.generate(
            conditioning,
            audio_prefix_codes=prefix_i,
            max_new_tokens=params_i.max_new_tokens,
            cfg_scale=params_i.cfg_scale,
            sampling_params=params_i.sampling,
            seed=params_i.seed,
        )
        lp = 0 if (i == 0 or prefix_i is None) else int(prefix_i.shape[-1])
        new_codes = np.asarray(codes)[..., lp:]
        total_tokens += int(new_codes.shape[-1])
        if new_codes.shape[-1] > 0:
            wav_i = model.autoencoder.decode(new_codes)[0, 0]
            if waves and not continuity:
                waves.append(gap)
            waves.append(np.asarray(wav_i, dtype=np.float32))
        if continuity:
            prev_tail = np.asarray(codes)[..., -min(tail_frames, codes.shape[-1]):]
    wav = np.concatenate(waves)
    if output_path is None:
        output_path = new_output_path()
    write_wav(output_path, wav, sr)
    wall_s = (time.perf_counter_ns() - t_start) / 1e9
    audio_s = wav.shape[-1] / sr
    rtf = audio_s / wall_s if wall_s > 0 else 0.0
    logger.info(
        f"longform: {len(chunks)} chunks, {audio_s:.2f}s audio in {wall_s:.2f}s "
        f"({rtf:.2f}x realtime, seed={params.seed}, tokens={total_tokens})"
    )
    return output_path, wav, sr, rtf


def tts(
    model,
    text: str,
    language: str = "en-us",
    speaker_audio: str | None = None,
    prefix_audio: str | None = None,
    model_name: str = C.MODEL_TRANSFORMER,
    emotion: list | None = None,
    fmax: float = 22050.0,
    pitch_std: float = 20.0,
    speaking_rate: float = 15.0,
    vqscore_8: list | None = None,
    ctc_loss: float = 0.0,
    dnsmos_ovrl: float = 4.0,
    speaker_noised: bool = False,
    unconditional_keys=frozenset({"vqscore_8", "dnsmos_ovrl"}),
    seed: int = C.DEFAULT_SEED,
    randomize_seed: bool = True,
    cfg_scale: float = 2.0,
    min_p: float = 0.1,
    output_path: str | None = None,
    chunk_long: bool = True,
    stats: dict | None = None,
) -> tuple[str, np.ndarray, int, float]:
    """One call for the server's request surface → (wav_path, waveform [T],
    sample_rate, rtf).

    The speaker wav becomes an embedding on the model's device, the prefix
    wav DAC codes that the model continues. Text beyond the 30-second token
    ceiling is sentence-chunked and the chunk waveforms concatenated unless
    ``chunk_long=False``. A ``stats`` dict receives ``speaker_s`` and
    ``prefix_s`` (host wall time of each set-up, results on the host) and,
    for a single-chunk request, ``generate_audio``'s timings.
    """
    params = prepare_generation_params(text, seed=seed, randomize_seed=randomize_seed, cfg_scale=cfg_scale,
                                       min_p=min_p)
    t = time.perf_counter()
    speaker = setup_speaker_conditioning(model_name, speaker_audio, device=model.device)
    t_speaker = time.perf_counter() - t
    prefix_codes = setup_prefix_audio(prefix_audio, model.autoencoder)
    if stats is not None:
        stats.update(speaker_s=t_speaker, prefix_s=time.perf_counter() - t - t_speaker)

    cond_kw = dict(
        language=language, speaker=speaker, emotion=emotion, fmax=fmax, pitch_std=pitch_std,
        speaking_rate=speaking_rate, vqscore_8=vqscore_8, ctc_loss=ctc_loss, dnsmos_ovrl=dnsmos_ovrl,
        speaker_noised=speaker_noised, unconditional_keys=unconditional_keys,
    )
    if chunk_long and longform.is_longform(text):
        return _generate_longform(model, text, params, prefix_codes, cond_kw, cfg_scale, min_p, output_path)
    cond = build_cond_dict(model, text=text, **cond_kw)
    return generate_and_save_audio(model, cond, params, audio_prefix_codes=prefix_codes, output_path=output_path,
                                   stats=stats)
