"""HTTP TTS server, SkyrimNet-compatible surface (port of ``zonos_tpu/serving/server.py``).

A dependency-free stdlib ``ThreadingHTTPServer`` with JAX's routes:

  GET  /health, /models, /languages, /conditioners, /ui_spec, /lexicon,
       /speakers, /metrics (Prometheus text), / (the web UI),
       /trace (the span recorder's ring, Chrome trace-event JSON)
  POST /generate  (JSON body) → WAV bytes; ``text="ping"`` → 100 ms of
       silence (SkyrimNet's health check)
  POST /stream    (JSON body) → chunked raw PCM16 (little-endian mono;
       X-Sample-Rate header), from the first decoded chunk on
  POST /v1/audio/speech → OpenAI-compatible wav
  POST /speakers, /lexicon → voice upload, pronunciation overrides

Single requests go through ``pipeline.tts`` (at most ``CONCURRENCY_LIMIT``
at once); ``ZONOS_BATCHING=1`` routes them through the continuous-batching
engine (``serving/continuous.py``), and with ``ZONOS_CONTINUOUS=0`` through
the dynamic batcher (``serving/batcher.py``). The model runs on the card,
int8-quantized (K1-K3); ``ZONOS_PLATFORM=cpu`` asks for the CPU, and
without it the server raises where there is no card.

    python -m zonos_tpu_torch.serving.server --port 7860

SIGTERM stops the server as Ctrl-C does; on the way out it writes the span
recorder's ring to ``<output dir>/spans.json`` (``utils/profiling.py``;
``ZONOS_TRACE=0`` turns the recorder off).
"""

from __future__ import annotations

import argparse
import io
import json
import logging
import signal
import struct
import threading
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from zonos_tpu_torch.serving import constants as C
from zonos_tpu_torch.serving import metrics
from zonos_tpu_torch.serving.app_config import load_config, setup_logging
from zonos_tpu_torch.serving.batcher import RequestTrace
from zonos_tpu_torch.serving.model_manager import get_supported_models, load_model_if_needed, serving_device
from zonos_tpu_torch.serving.pipeline import tts
from zonos_tpu_torch.utils import profiling

_GEN_SEMAPHORE = threading.Semaphore(C.CONCURRENCY_LIMIT)
_APP_CONFIG: dict = {}
# The request the handler thread serves (``batcher.RequestTrace``, made in
# ``Handler._post``); ``handle_stream`` and ``handle_generate`` read it here,
# so their signatures stay ``(body)``.
_LOCAL = threading.local()


def _current_trace() -> RequestTrace | None:
    return getattr(_LOCAL, "trace", None)


def _silence_wav(ms: int = 100, sr: int = 44100) -> bytes:
    """Canned silence for the "ping" protocol."""
    n = int(sr * ms / 1000)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(b"\x00\x00" * n)
    return buf.getvalue()


def _wav_bytes(wav: np.ndarray, sr: int) -> bytes:
    if wav.dtype == np.int16:  # already device-quantized PCM
        pcm = wav.astype("<i2", copy=False)
    else:
        pcm = np.clip(wav * 32767.0, -32767.0, 32767.0).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


_SERVER: ThreadingHTTPServer | None = None  # the listening server of main(), for its caller to shut down
_BATCHER = None
_BATCHER_MODEL = None  # the model the live batcher/engine is bound to
_BATCHER_LOCK = threading.Lock()


def _get_batcher(model):
    """Lazy dynamic batcher (opt-in: ZONOS_BATCHING=1 or config flag).

    Bound to ``model``: a model switch (model_manager reload-on-switch)
    closes the old engine and builds one for the new model — a batcher kept
    from the previous model would synthesize with the wrong weights/config.
    """
    import os

    if not (os.environ.get("ZONOS_BATCHING") == "1" or _APP_CONFIG.get("ZONOS_BATCHING")):
        return None
    global _BATCHER, _BATCHER_MODEL
    with _BATCHER_LOCK:
        if _BATCHER is not None and _BATCHER_MODEL is not model:
            try:
                _BATCHER.close()
            except Exception:  # pragma: no cover - defensive
                logging.getLogger(__name__).exception("closing stale batcher failed")
            _BATCHER = None
        if _BATCHER is None:
            _BATCHER_MODEL = model
            max_batch = int(
                os.environ.get("ZONOS_MAX_BATCH", 0)
                or _APP_CONFIG.get("ZONOS_MAX_BATCH", 0)
                or 8
            )
            continuous = os.environ.get("ZONOS_CONTINUOUS", "1") == "1"
            if continuous:
                # Continuous batching: requests join/leave one long-lived
                # batched decode at segment boundaries (serving/continuous.py)
                # — early-EOS slots recycle instead of idling. Both backbones
                # (hybrid Mamba states join by row scatter);
                # ZONOS_CONTINUOUS=0 reverts to form-then-run batches.
                from zonos_tpu_torch.serving.continuous import ContinuousEngine

                cap = int(
                    os.environ.get("ZONOS_ENGINE_MAX_NEW", 0)
                    or _APP_CONFIG.get("ZONOS_ENGINE_MAX_NEW", 0)
                    or 86 * 30
                )
                _BATCHER = ContinuousEngine(
                    model, slots=max_batch, max_new_cap=cap, window_ms=30
                )
            else:
                from zonos_tpu_torch.serving.batcher import DynamicBatcher

                _BATCHER = DynamicBatcher(model, max_batch=max_batch, window_ms=30)
        return _BATCHER


def _control_kwargs(body: dict) -> dict:
    """Extract the full conditioning control surface from a request body.

    Shared by /generate and /stream so the two endpoints build IDENTICAL
    cond dicts from the same body (the reference UI exposes all of these;
    SkyrimNet-Zonos.py:122-170)."""
    emotion = body.get("emotion")
    if emotion is None:
        e_sliders = [
            body.get(f"e_{name}") for name in C.EMOTION_NAMES
        ]
        if any(v is not None for v in e_sliders):
            emotion = [
                float(v) if v is not None else float(d)
                for v, d in zip(e_sliders, C.DEFAULT_EMOTION)
            ]
    return dict(
        language=body.get("language", "en-us"),
        emotion=emotion,
        fmax=float(body.get("fmax", 22050.0)),
        pitch_std=float(body.get("pitch_std", 20.0)),
        speaking_rate=float(body.get("speaking_rate", 15.0)),
        vqscore_8=body.get("vqscore_8"),
        ctc_loss=float(body.get("ctc_loss", 0.0)),
        dnsmos_ovrl=float(body.get("dnsmos_ovrl", 4.0)),
        speaker_noised=bool(body.get("speaker_noised", False)),
        unconditional_keys=frozenset(
            body.get("unconditional_keys", ["vqscore_8", "dnsmos_ovrl"])
        ),
    )


_SPEAKERS_DIR = "speakers"
_SPEAKER_EXTS = (".wav", ".mp3", ".flac", ".ogg")


def list_speakers() -> list[str]:
    """Registered voice names: relative stems of audio files under
    speakers/ (the reference's bundled-voice directory, audio_utils.py:108)."""
    import os

    out = []
    for root, _dirs, files in os.walk(_SPEAKERS_DIR):
        for f in sorted(files):
            stem, ext = os.path.splitext(f)
            if ext.lower() in _SPEAKER_EXTS:
                rel = os.path.relpath(os.path.join(root, stem), _SPEAKERS_DIR)
                out.append(rel.replace(os.sep, "/"))
    return out


def _safe_speaker_name(name: str) -> str | None:
    import re as _re

    name = name.strip().replace("\\", "/")
    if not name or not _re.fullmatch(r"[A-Za-z0-9_\-]+(/[A-Za-z0-9_\-]+)*", name):
        return None
    return name


def _write_atomic(path: str, data: bytes) -> None:
    """Write ``data`` to a temporary file of this process and thread, then
    rename it to ``path``: another server process in the same working
    directory (one per card behind serving/router.py) sees the old file, no
    file, or the whole new one, never a part."""
    import os

    from zonos_tpu_torch.serving.caches import writer_tag

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{writer_tag()}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def save_speaker(name: str, wav_bytes: bytes) -> str:
    """Store an uploaded voice under speakers/uploads/<name>.wav."""
    import os

    safe = _safe_speaker_name(name)
    if safe is None:
        raise ValueError("speaker name must be [A-Za-z0-9_-]+ (optional / path)")
    path = os.path.join(_SPEAKERS_DIR, "uploads", *safe.split("/")) + ".wav"
    _write_atomic(path, wav_bytes)
    return "uploads/" + safe


def resolve_speaker_path(body: dict) -> str | None:
    """Request → speaker wav path. Precedence: explicit server-side path
    ("speaker_audio") → registered voice name ("speaker", resolved under
    speakers/ — the reference UI's bundled-voice dropdown as an API) →
    inline audio ("speaker_wav_base64", content-addressed temp file so
    remote clients can voice-clone without filesystem access)."""
    import base64
    import hashlib
    import os

    if body.get("speaker_audio"):
        return str(body["speaker_audio"])
    name = body.get("speaker")
    if name:
        safe = _safe_speaker_name(str(name))
        if safe is None:
            raise ValueError(f"invalid speaker name: {name!r}")
        for ext in _SPEAKER_EXTS:
            cand = os.path.join(_SPEAKERS_DIR, *safe.split("/")) + ext
            if os.path.exists(cand):
                return cand
        raise ValueError(f"unknown speaker: {name!r} (GET /speakers lists voices)")
    b64 = body.get("speaker_wav_base64")
    if b64:
        raw = base64.b64decode(b64)
        digest = hashlib.sha1(raw).hexdigest()[:16]
        path = os.path.join("cache", "uploads", f"{digest}.wav")
        if not os.path.exists(path):  # content-addressed: any writer's file is this one
            _write_atomic(path, raw)
        return path
    return None


def handle_generate(body: dict) -> tuple[bytes, dict]:
    """Core request handler; returns (wav_bytes, metadata)."""
    text = str(body.get("text", ""))
    if text.strip().lower() == "ping":
        return _silence_wav(), {"ping": True}

    model_name = body.get("model_choice", C.MODEL_TRANSFORMER)
    model = load_model_if_needed(model_name, _APP_CONFIG)

    from zonos_tpu_torch.serving import longform

    # Dynamic batching path: concurrent requests coalesce into one decode
    # (aggregate throughput; see serving/batcher.py). Prefix-audio and
    # long-form requests fall through to the single-request path (the
    # latter sentence-chunk inside pipeline.tts).
    batcher = _get_batcher(model)
    if batcher is not None and not body.get("prefix_audio") and not longform.is_longform(text):
        import time as _time

        from zonos_tpu_torch.serving.batcher import TTSRequest
        from zonos_tpu_torch.serving.pipeline import prepare_generation_params, setup_speaker_conditioning
        from zonos_tpu_torch.ops.sampling import SamplingParams

        params = prepare_generation_params(
            text,
            seed=int(body.get("seed", C.DEFAULT_SEED)),
            randomize_seed=bool(body.get("randomize_seed", True)),
            cfg_scale=float(body.get("cfg_scale", 2.0)),
            min_p=float(body.get("min_p", 0.1)),
        )
        speaker = setup_speaker_conditioning(model_name, resolve_speaker_path(body), device=model.device)
        controls = _control_kwargs(body)
        t0 = _time.perf_counter()
        wav, sr = batcher.submit(
            TTSRequest(
                text=text,
                language=controls["language"],
                speaker=speaker,
                emotion=controls["emotion"],
                fmax=controls["fmax"],
                pitch_std=controls["pitch_std"],
                speaking_rate=controls["speaking_rate"],
                vqscore_8=tuple(controls["vqscore_8"]) if controls["vqscore_8"] else None,
                ctc_loss=controls["ctc_loss"],
                dnsmos_ovrl=controls["dnsmos_ovrl"],
                speaker_noised=controls["speaker_noised"],
                seed=params.seed,
                max_new_tokens=params.max_new_tokens,
                cfg_scale=params.cfg_scale,
                sampling=SamplingParams(**params.sampling),
                unconditional_keys=controls["unconditional_keys"],
                no_batch=bool(body.get("no_batch", False)),
                trace=_current_trace(),
            )
        )
        rtf = (wav.shape[0] / sr) / max(_time.perf_counter() - t0, 1e-9)
        metrics.observe_generation(rtf, wav.shape[0] / sr)
        return _wav_bytes(wav, sr), {"rtf": rtf, "sample_rate": sr, "batched": True}

    controls = _control_kwargs(body)

    with _GEN_SEMAPHORE:
        path, wav, sr, rtf = tts(
            model,
            text=text,
            speaker_audio=resolve_speaker_path(body),
            prefix_audio=body.get("prefix_audio"),
            model_name=model_name,
            seed=int(body.get("seed", C.DEFAULT_SEED)),
            randomize_seed=bool(body.get("randomize_seed", True)),
            cfg_scale=float(body.get("cfg_scale", 2.0)),
            min_p=float(body.get("min_p", 0.1)),
            **controls,
        )
    metrics.observe_generation(rtf, len(wav) / sr)
    return _wav_bytes(wav, sr), {"path": path, "rtf": rtf, "sample_rate": sr}


def handle_stream(body: dict):
    """Yield raw PCM16 chunks for a streaming TTS request.

    Conditioning parity with /generate: the full control set (emotion, fmax,
    pitch_std, speaking_rate, vqscore_8, ctc_loss, dnsmos_ovrl,
    speaker_noised, unconditional_keys) and prefix audio all apply here too.
    """
    import numpy as np

    from zonos_tpu_torch.serving.pipeline import (
        build_cond_dict,
        prepare_generation_params,
        setup_prefix_audio,
        setup_speaker_conditioning,
    )

    text = str(body.get("text", ""))
    model_name = body.get("model_choice", C.MODEL_TRANSFORMER)
    model = load_model_if_needed(model_name, _APP_CONFIG)
    params = prepare_generation_params(
        text,
        seed=int(body.get("seed", C.DEFAULT_SEED)),
        randomize_seed=bool(body.get("randomize_seed", True)),
        cfg_scale=float(body.get("cfg_scale", 2.0)),
        min_p=float(body.get("min_p", 0.1)),
    )
    speaker = setup_speaker_conditioning(model_name, resolve_speaker_path(body), device=model.device)

    from zonos_tpu_torch.serving import longform

    # Batched streaming: concurrent /stream requests coalesce into one
    # chunked decode (serving/batcher._run_stream_batch) instead of
    # serializing behind the semaphore at batch 1. Long-form requests go
    # through the sequential per-chunk path below.
    batcher = _get_batcher(model)
    if batcher is not None and not body.get("prefix_audio") and not longform.is_longform(text):
        from zonos_tpu_torch.ops.sampling import SamplingParams
        from zonos_tpu_torch.serving.batcher import TTSRequest

        controls = _control_kwargs(body)
        req = TTSRequest(
            text=text,
            language=controls["language"],
            speaker=speaker,
            emotion=controls["emotion"],
            fmax=controls["fmax"],
            pitch_std=controls["pitch_std"],
            speaking_rate=controls["speaking_rate"],
            vqscore_8=tuple(controls["vqscore_8"]) if controls["vqscore_8"] else None,
            ctc_loss=controls["ctc_loss"],
            dnsmos_ovrl=controls["dnsmos_ovrl"],
            speaker_noised=controls["speaker_noised"],
            seed=params.seed,
            max_new_tokens=params.max_new_tokens,
            cfg_scale=params.cfg_scale,
            sampling=SamplingParams(**params.sampling),
            unconditional_keys=controls["unconditional_keys"],
            no_batch=bool(body.get("no_batch", False)),
            trace=_current_trace(),
        )
        for wav, sr in batcher.submit_stream(req):
            if wav.dtype == np.int16:  # engine ships device-quantized PCM
                pcm = wav.astype("<i2", copy=False)
            else:
                pcm = np.clip(wav * 32767.0, -32767.0, 32767.0).astype("<i2")
            yield pcm.tobytes(), sr
        return

    prefix_codes = setup_prefix_audio(body.get("prefix_audio"), model.autoencoder)
    controls = _control_kwargs(body)
    # Long-form requests stream chunk after chunk with a short silence
    # between them — TTFA stays that of the FIRST chunk regardless of the
    # total text length. plan_chunks is the SAME protocol /generate uses
    # (pipeline.tts), so both surfaces produce identical chunking.
    from zonos_tpu_torch.serving.pipeline import plan_chunks

    chunks = plan_chunks(text, params, params.cfg_scale, float(body.get("min_p", 0.1)))

    with _GEN_SEMAPHORE:
        for i, (chunk, params_i) in enumerate(chunks):
            cond_dict = build_cond_dict(model, text=chunk, speaker=speaker, **controls)
            # use_cache: repeated streaming requests with identical
            # conditioning skip the conditioner stack (parity with /generate).
            conditioning = model.prepare_conditioning(
                cond_dict, cfg_scale=params.cfg_scale, use_cache=True
            )
            sr_out = model.autoencoder.sampling_rate
            if i:
                gap = np.zeros(int(longform.CHUNK_GAP_S * sr_out), dtype="<i2")
                yield gap.tobytes(), sr_out
            for wav, sr in model.stream(
                conditioning,
                audio_prefix_codes=prefix_codes if i == 0 else None,
                max_new_tokens=params_i.max_new_tokens,
                cfg_scale=params_i.cfg_scale,
                sampling_params=params_i.sampling,
                seed=params_i.seed,
            ):
                pcm = np.clip(wav * 32767.0, -32767.0, 32767.0).astype("<i2")
                yield pcm.tobytes(), sr


def warmup(model_name: str | None = None, stream: bool = True) -> float:
    """One short generate and one drained stream before the listen socket
    opens: the first real request then finds the kernels loaded, the G2P
    library built and the DAC and speaker tower in place. Returns the wall
    seconds spent."""
    import time as _time

    t0 = _time.perf_counter()
    body = {
        "text": "The quick brown fox jumps over the lazy dog.",
        "randomize_seed": False,
        "seed": 0,
    }
    if model_name:
        body["model_choice"] = model_name
    handle_generate(dict(body))
    if stream:
        for _ in handle_stream(dict(body)):
            pass
    return _time.perf_counter() - t0


class Handler(BaseHTTPRequestHandler):
    server_version = "ZonosTPU/0.1"
    _status = 0  # last response code, for the /metrics request counter

    def _send(self, code: int, content_type: str, payload: bytes, headers: dict | None = None):
        self._status = code
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(payload)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(payload)

    def _json(self, code: int, obj):
        self._send(code, "application/json", json.dumps(obj).encode())

    def do_GET(self):
        import time as _time

        t0 = _time.perf_counter()
        try:
            self._get()
        finally:
            metrics.observe_request(self.path, self._status, _time.perf_counter() - t0)

    def _get(self):
        if self.path in ("/", "/index.html"):
            # Dependency-free web UI (replaces the reference's Gradio app).
            import os

            page = os.path.join(os.path.dirname(os.path.abspath(__file__)), "webui.html")
            with open(page, "rb") as f:
                self._send(200, "text/html; charset=utf-8", f.read())
        elif self.path == "/health":
            self._json(200, {"status": "ok"})
        elif self.path == "/models":
            self._json(200, {"models": get_supported_models()})
        elif self.path == "/languages":
            from zonos_tpu_torch.conditioning import native_g2p
            from zonos_tpu_torch.conditioning.cond_dict import supported_language_codes
            from zonos_tpu_torch.conditioning.espeak import espeak_available

            self._json(200, {
                "languages": list(supported_language_codes),
                "espeak": espeak_available(),
                "native_g2p": native_g2p.available(),
            })
        elif self.path == "/conditioners":
            model = load_model_if_needed(config=_APP_CONFIG)
            self._json(200, {"conditioners": model.conditioner_names})
        elif self.path == "/ui_spec":
            from zonos_tpu_torch.serving.ui import control_specs

            model = load_model_if_needed(config=_APP_CONFIG)
            self._json(200, {"controls": control_specs(model.conditioner_names)})
        elif self.path == "/lexicon":
            from zonos_tpu_torch.conditioning import lexicon

            self._json(200, {"entries": lexicon.entries()})
        elif self.path == "/speakers":
            self._json(200, {"speakers": list_speakers()})
        elif self.path == "/metrics":
            # Prometheus text exposition (serving/metrics.py).
            self._send(
                200, "text/plain; version=0.0.4; charset=utf-8",
                metrics.REGISTRY.render().encode(),
            )
        elif self.path == "/trace":
            # The span recorder's ring as Chrome trace-event JSON (utils/profiling.py).
            self._send(200, "application/json", json.dumps(profiling.RECORDER.chrome_trace()).encode())
        else:
            self._json(404, {"error": "not found"})

    def do_POST(self):
        import time as _time

        t0 = _time.perf_counter()
        try:
            self._post()
        finally:
            metrics.observe_request(self.path, self._status, _time.perf_counter() - t0)

    def _post(self):
        # This request's id and stage instants: spans opened on this thread
        # carry the id, and the engine marks the stages it reaches.
        _LOCAL.trace = rt = RequestTrace()
        try:
            with profiling.attach(rt.id), profiling.span("request", endpoint=self.path):
                self._route(rt)
        finally:
            _LOCAL.trace = None

    def _route(self, rt: RequestTrace):
        if self.path == "/generate":
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
                wav_bytes, meta = handle_generate(body)
                with profiling.span("front.write"):
                    self._send(200, "audio/wav", wav_bytes, {"X-Zonos-Meta": json.dumps(meta)})
            except ValueError as e:
                # Client errors (unknown speaker name, malformed fields).
                self._json(400, {"error": str(e)})
            except Exception as e:
                import traceback

                traceback.print_exc()
                self._json(500, {"error": str(e)})
        elif self.path == "/stream":
            # headers_sent: once chunked streaming has begun we can no
            # longer send an HTTP error response — writing one would inject
            # a raw status line into the PCM body. Mid-stream failures
            # close the connection WITHOUT the terminal 0-chunk, which
            # clients see as a truncated (invalid) chunked stream.
            headers_sent = False
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
                gen = handle_stream(body)
                first_chunk, sr = next(gen)
                self._status = 200
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("Transfer-Encoding", "chunked")
                self.send_header("X-Sample-Rate", str(sr))
                self.send_header("X-PCM-Format", "s16le-mono")
                self.end_headers()
                headers_sent = True

                def write_chunk(data: bytes):
                    self.wfile.write(f"{len(data):X}\r\n".encode())
                    self.wfile.write(data)
                    self.wfile.write(b"\r\n")

                write_chunk(first_chunk)
                # Read → first byte in six stages, where the engine served it.
                rt.mark("written")
                rt.record_stages()
                for data, _sr in gen:
                    write_chunk(data)
                self.wfile.write(b"0\r\n\r\n")
            except ValueError as e:
                if not headers_sent:
                    try:
                        self._json(400, {"error": str(e)})
                    except Exception:
                        pass
            except Exception as e:
                import traceback

                traceback.print_exc()
                if not headers_sent:
                    try:
                        self._json(500, {"error": str(e)})
                    except Exception:
                        pass
        elif self.path == "/v1/audio/speech":
            # OpenAI-compatible TTS surface: {"input": text, "voice": name,
            # "model"?: ..., "response_format"?: "wav"} → audio bytes.
            # Lets existing OpenAI-SDK clients point at this server.
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
                mapped = {
                    "text": str(body.get("input", "")),
                    "language": body.get("language", "en-us"),
                }
                voice = body.get("voice")
                if voice and voice not in ("alloy", "echo", "fable", "onyx",
                                           "nova", "shimmer"):
                    mapped["speaker"] = voice  # registered voice name
                if body.get("seed") is not None:
                    mapped["seed"] = int(body["seed"])
                    mapped["randomize_seed"] = False
                if body.get("speed") is not None:
                    # speaking_rate 15 is the neutral default (phonemes/s);
                    # clamp to the conditioner's trained range.
                    mapped["speaking_rate"] = max(
                        5.0, min(40.0, 15.0 * float(body["speed"]))
                    )
                fmt = body.get("response_format", "wav")
                if fmt != "wav":
                    self._json(400, {"error": f"unsupported response_format {fmt!r}; this server emits wav"})
                    return
                wav_bytes, meta = handle_generate(mapped)
                self._send(200, "audio/wav", wav_bytes,
                           {"X-Zonos-Meta": json.dumps(meta)})
            except ValueError as e:
                self._json(400, {"error": str(e)})
            except Exception as e:
                import traceback

                traceback.print_exc()
                self._json(500, {"error": str(e)})
        elif self.path == "/speakers":
            # Voice upload: {"name": "myvoice", "wav_base64": "..."} →
            # stored under speakers/uploads/, then usable as "speaker": name.
            import base64

            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
                name = str(body.get("name", ""))
                raw = base64.b64decode(body.get("wav_base64", "") or "")
                if not raw:
                    self._json(400, {"error": "wav_base64 required"})
                    return
                stored = save_speaker(name, raw)
                self._json(200, {"speaker": stored})
            except ValueError as e:
                self._json(400, {"error": str(e)})
            except Exception as e:
                self._json(500, {"error": str(e)})
        elif self.path == "/lexicon":
            # Pronunciation overrides: {"entries": {word: ipa}, "language"?: str,
            # "remove"?: [words] | "clear": true}. Applies to every G2P backend.
            from zonos_tpu_torch.conditioning import lexicon

            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
                if body.get("clear"):
                    total = lexicon.remove(None)
                elif body.get("remove"):
                    total = lexicon.remove(list(body["remove"]))
                else:
                    total = lexicon.set_entries(
                        dict(body.get("entries") or {}), body.get("language")
                    )
                self._json(200, {"total": total})
            except Exception as e:
                self._json(400, {"error": str(e)})
        else:
            self._json(404, {"error": "not found"})

    def log_message(self, fmt, *args):  # route to our logger
        logging.getLogger("zonos_tpu_torch").debug("http: " + fmt % args)


def main(argv=None):
    import os

    # Bucket phoneme lengths server-wide, as the JAX server does (its shapes
    # key its compiles); left-padding with attended PAD_ID embeddings is how
    # every batched text is treated. ZONOS_PHONEME_BUCKET=1 gives unpadded
    # lengths.
    from zonos_tpu_torch.conditioning import text as _text

    _text.PAD_BUCKET = int(os.environ.get("ZONOS_PHONEME_BUCKET", "32"))

    parser = argparse.ArgumentParser(description="Zonos TTS server (PyTorch/CUDA)")
    parser.add_argument("--server", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=7860)
    parser.add_argument("--model", default=C.MODEL_TRANSFORMER)
    parser.add_argument("--checkmodels", action="store_true")
    parser.add_argument("--sysreport", action="store_true")
    parser.add_argument("--no-preload", action="store_true")
    parser.add_argument(
        "--warmup", action="store_true",
        help="run one generate and one stream before serving (also: ZONOS_WARMUP=1), "
             "so the first request finds the kernels built and the caches warm",
    )
    parser.add_argument(
        "--lexicon", default=os.environ.get("ZONOS_LEXICON", ""),
        help="JSON pronunciation-override file: {word: ipa} or "
             "{language: {word: ipa}} ('*' = global); also POST /lexicon",
    )
    # SkyrimNet CLI compatibility: --share is a Gradio public-link option.
    parser.add_argument("--share", action="store_true", help="(ignored; reference compat)")
    args = parser.parse_args(argv)
    if args.share:
        print("--share is a Gradio feature; ignored by the HTTP server")

    global _APP_CONFIG, _SERVER
    _APP_CONFIG = load_config()
    logger = setup_logging(_APP_CONFIG)
    profiling.configure_tracing(_APP_CONFIG)

    if args.lexicon:
        from zonos_tpu_torch.conditioning import lexicon as _lex

        total = _lex.load_file(args.lexicon)
        logger.info(f"pronunciation lexicon: {total} entries from {args.lexicon}")

    if args.sysreport:
        from zonos_tpu_torch.utils.sysinfo import generate_report

        print(generate_report(_APP_CONFIG))
        return
    if args.checkmodels:
        from zonos_tpu_torch.utils.sysinfo import check_models

        print(check_models(_APP_CONFIG))
        return

    # The card, or the CPU if ZONOS_PLATFORM=cpu asks for it: raises here,
    # before anything is served, when there is no card.
    device = serving_device()
    from zonos_tpu_torch.utils.compile_cache import enable as enable_compile_cache

    logger.info(f"serving on {device}; kernels in {enable_compile_cache(device)}")

    if not args.no_preload:
        load_model_if_needed(args.model, _APP_CONFIG)
        from zonos_tpu_torch.serving.audio_prep import init_latent_cache

        init_latent_cache("speakers/en", args.model, device=device)
        logger.info(f"model preloaded: {args.model}")

    if args.warmup or os.environ.get("ZONOS_WARMUP") == "1":
        logger.info("warmup: one generate and one stream ...")
        with profiling.span("server.warmup"):
            dt = warmup(args.model)
        logger.info(f"warmup done in {dt:.1f}s; first request is steady-state")

    server = ThreadingHTTPServer((args.server, args.port), Handler)
    _SERVER = server
    # SIGTERM stops the server as Ctrl-C does. A signal handler can only be
    # installed from the main thread; a caller running main() in another
    # thread stops it with _SERVER.shutdown().
    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, _interrupt)
    logger.info(f"Zonos (PyTorch/CUDA) serving on http://{args.server}:{args.port}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    finally:
        server.server_close()
        if profiling.RECORDER.enabled:
            from zonos_tpu_torch.serving.caches import get_output_dir

            path = profiling.RECORDER.write_chrome_trace(os.path.join(get_output_dir(), "spans.json"))
            logger.info(f"spans written to {path}")


def _interrupt(signum, frame):
    raise KeyboardInterrupt


if __name__ == "__main__":
    main()
