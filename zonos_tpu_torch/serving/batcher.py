"""Dynamic request batching: coalesce concurrent TTS requests into one decode
(port of ``zonos_tpu/serving/batcher.py``).

The decode step streams every weight once whatever the batch, so requests
that arrive together share it. This batcher:

* collects requests for up to ``window_ms`` (or until ``max_batch``),
* groups them by signature (sampling params, cfg_scale, bucketed
  max_new_tokens, unconditional keys, scalar controls, stream or not),
* builds ONE batched conditioning (texts, speakers and controls stack on the
  batch axis) and runs ONE ``generate_audio`` (or ``generate_stream``) of up
  to ``max_batch`` requests (16 requests are 32 rows with CFG: one K1 or K3
  launch each),
* hands each request its own valid PCM.

Batched requests share the group's generation length ceiling; EOS still
stops per sample, and each sample's audio ends at its own boundary. Every
row draws from its own request-seeded generator (``row_generators`` with one
seed per row), so a fixed-seed request reproduces its solo run. The PCM is
int16, quantized on the device, unless ``ZONOS_PCM_INT16=0`` (the JAX
batcher returns float32; the JAX engine int16).
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import os
import queue
import threading
import time
from typing import Any

import numpy as np

from zonos_tpu_torch.conditioning.cond_dict import make_cond_dict
from zonos_tpu_torch.ops.sampling import SamplingParams
from zonos_tpu_torch.serving import metrics
from zonos_tpu_torch.utils import profiling

logger = logging.getLogger("zonos_tpu_torch")

# A /stream request served by the continuous engine, from its read to its
# first PCM byte written: (stage, the mark it starts at, the mark it ends at).
# The six tile that time with no gap and no overlap.
STREAM_STAGES = (
    ("front.read", "read", "queued"),
    ("prep", "queued", "prepped"),
    ("engine.join_wait", "prepped", "joined"),
    ("engine.first_audio", "joined", "planned"),
    ("ship", "planned", "shipped"),
    ("front.write", "shipped", "written"),
)
_REQUEST_IDS = itertools.count(1)


class RequestTrace:
    """One served request: its id, and the first instant
    (``perf_counter_ns``) at each of its stage boundaries, on whatever
    thread reached it."""

    __slots__ = ("id", "marks")

    def __init__(self):
        self.id = next(_REQUEST_IDS)
        self.marks = {"read": time.perf_counter_ns()}

    def mark(self, boundary: str) -> None:
        """The instant the request first reaches ``boundary``; later ones are kept out."""
        if boundary not in self.marks:
            self.marks[boundary] = time.perf_counter_ns()

    def record_stages(self) -> None:
        """Record each of ``STREAM_STAGES`` whose two marks were reached, as
        spans of this request under the span open on the calling thread."""
        for name, a, b in STREAM_STAGES:
            if a in self.marks and b in self.marks:
                profiling.record(name, self.marks[a], self.marks[b], req=self.id)


@dataclasses.dataclass
class TTSRequest:
    text: str
    language: str = "en-us"
    speaker: np.ndarray | None = None  # [1, 1, 128]
    emotion: list | None = None
    fmax: float = 22050.0
    pitch_std: float = 20.0
    speaking_rate: float = 15.0
    # Scalar quality controls: batched by grouping (only identical values
    # coalesce — see group_key) rather than by stacking.
    vqscore_8: tuple | None = None
    ctc_loss: float = 0.0
    dnsmos_ovrl: float = 4.0
    speaker_noised: bool = False
    seed: int = 0
    max_new_tokens: int = 86 * 10
    cfg_scale: float = 2.0
    sampling: SamplingParams = dataclasses.field(default_factory=lambda: SamplingParams(min_p=0.1))
    unconditional_keys: frozenset = frozenset({"vqscore_8", "dnsmos_ovrl"})
    # Escape hatch: never coalesce this request with others (pure isolation;
    # per-row PRNG chains already make fixed-seed output batch-independent).
    no_batch: bool = False
    # Streaming request: the batcher runs the chunked decode and feeds this
    # request's per-sample PCM chunks through ``chunks`` (None sentinel =
    # stream complete). Stream and non-stream requests never coalesce.
    stream: bool = False
    # The served request's id and the instants at its stage boundaries
    # (``RequestTrace``), where the server made one.
    trace: RequestTrace | None = None

    # filled by the batcher
    _event: threading.Event = dataclasses.field(default_factory=threading.Event)
    _result: Any = None
    # Set once a terminal None (success OR error) has been queued; guards
    # against a later epoch failure retroactively poisoning a request that
    # already completed (its consumer may not have drained the queue yet).
    _finished: bool = False
    _error: Exception | None = None
    chunks: "queue.Queue[tuple | None]" = dataclasses.field(default_factory=queue.Queue)

    def group_key(self, bucket: int = 256) -> tuple:
        max_new_b = -(-self.max_new_tokens // bucket) * bucket
        solo = id(self) if self.no_batch else None
        return (
            self.cfg_scale, self.sampling, max_new_b, self.unconditional_keys,
            self.language[:2], self.vqscore_8, self.ctc_loss, self.dnsmos_ovrl,
            self.speaker_noised, solo, self.stream,
        )


class DynamicBatcher:
    """Background-thread batcher around a Zonos model."""

    # int8 KV (K2) up to 8 requests, 16 rows with CFG; above that bf16 KV, as
    # the JAX batcher chooses.
    KV8_MAX_BATCH = 8

    def __init__(self, model, max_batch: int = 8, window_ms: float = 30.0):
        self.model = model
        self.max_batch = max_batch
        self.window_s = window_ms / 1000.0
        self._queue: queue.Queue[TTSRequest] = queue.Queue()
        self._stop = threading.Event()
        self.stats = {"requests": 0, "batches": 0, "batched_requests": 0}
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------

    def submit(self, request: TTSRequest, timeout: float = 600.0):
        """Blocking submit: returns (wav [T], sample_rate): int16 by default
        (``ZONOS_PCM_INT16=0``: float32)."""
        self._queue.put(request)
        if not request._event.wait(timeout):
            raise TimeoutError("TTS request timed out")
        if request._error is not None:
            raise request._error
        return request._result

    def submit_stream(self, request: TTSRequest, timeout: float = 600.0):
        """Streaming submit: yields (pcm [T] float32, sample_rate) chunks.

        Concurrent /stream requests coalesce into ONE batched chunked decode
        (``runtime/streaming.generate_stream`` batch mode); each request reads
        its own sample's chunks from a queue as segments finish. A request's
        stream ends when its own EOS boundary is reached, even if batchmates
        are still talking.
        """
        request.stream = True
        self._queue.put(request)
        while True:
            try:
                item = request.chunks.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError("TTS stream request timed out") from None
            if item is None:
                if request._error is not None:
                    raise request._error
                return
            yield item

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)

    # ------------------------------------------------------------------

    def _collect(self) -> list[TTSRequest]:
        try:
            first = self._queue.get(timeout=0.1)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.monotonic() + self.window_s
        key = first.group_key()
        pending: list[TTSRequest] = []
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                req = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if req.group_key() == key:
                batch.append(req)
            else:
                pending.append(req)  # different signature → next batch
        for req in pending:
            self._queue.put(req)
        return batch

    def _worker(self):
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                continue
            try:
                self._run_batch(batch)
            except Exception as e:  # pragma: no cover - defensive
                for req in batch:
                    req._error = e
                    req._event.set()

    def _run_batch(self, batch: list[TTSRequest]):
        b = len(batch)
        self.stats["requests"] += b
        self.stats["batches"] += 1
        if b > 1:
            self.stats["batched_requests"] += b
        metrics.observe_batch(b)

        first = batch[0]
        if first.stream:
            try:
                self._run_stream_batch(batch)
            except Exception as e:
                for req in batch:
                    req._error = e
                    req.chunks.put(None)
            return

        cond_dict = self._batched_cond_dict(batch)
        conditioning = self.model.prepare_conditioning(cond_dict, cfg_scale=first.cfg_scale)
        max_new = max(r.max_new_tokens for r in batch)
        # int8 KV up to KV8_MAX_BATCH requests, bf16 above (None = the model's
        # default, int8 for a quantized serving model).
        kv_int8 = False if b > self.KV8_MAX_BATCH else None
        # Pipelined generate + DAC (same tokens and lengths as generate() +
        # decode(); the codec runs on settled spans while the decode goes on).
        wavs, lengths = self.model.generate_audio(
            conditioning,
            max_new_tokens=max_new,
            cfg_scale=first.cfg_scale,
            batch_size=b,
            sampling_params=first.sampling,
            # Per-request seeds: each row's generator is its own request's,
            # so a batched request reproduces its solo stream exactly.
            seed=[int(r.seed) & 0x7FFFFFFF for r in batch],
            kv_int8=kv_int8,
            pcm_int16=os.environ.get("ZONOS_PCM_INT16", "1") != "0",
        )
        sr = self.model.autoencoder.sampling_rate
        hop = self.model.autoencoder.config.hop_length
        for i, req in enumerate(batch):
            # Each request gets only ITS OWN valid frames: a short utterance
            # batched with a long one must not ship the long one's tail.
            req._result = (np.asarray(wavs[i])[: int(lengths[i]) * hop], sr)
            req._event.set()

    def _run_stream_batch(self, batch: list[TTSRequest]):
        """Batched chunked decode feeding per-request chunk queues.

        N coalesced /stream requests run ONE chunked decode loop
        (``runtime/streaming.generate_stream`` batch mode, one batched DAC call
        per segment); each request's queue receives its own sample's PCM and
        closes at its own EOS boundary even if batchmates keep talking.
        """
        from zonos_tpu_torch.runtime.streaming import generate_stream

        b = len(batch)
        first = batch[0]
        cond_dict = self._batched_cond_dict(batch)
        conditioning = self.model.prepare_conditioning(cond_dict, cfg_scale=first.cfg_scale)
        max_new = max(r.max_new_tokens for r in batch)
        sr = self.model.autoencoder.sampling_rate
        hop = self.model.autoencoder.config.hop_length
        kv_int8 = self.model.default_kv_int8 if b <= self.KV8_MAX_BATCH else False
        emitted = [0] * b   # PCM samples already shipped per request
        closed = [False] * b
        for item, _sr in generate_stream(
            self.model.params, self.model.config, conditioning,
            autoencoder=self.model.autoencoder,
            max_new_tokens=max_new, cfg_scale=first.cfg_scale, batch_size=b,
            sampling_params=first.sampling,
            seed=[int(r.seed) & 0x7FFFFFFF for r in batch],
            dtype=self.model.dtype, kv_int8=kv_int8, device=self.model.device,
        ):
            if b == 1:
                pcm = np.asarray(item)[None, :]
                lengths, final = None, None
            else:
                pcm, lengths, final = item
            for i, req in enumerate(batch):
                if closed[i]:
                    continue
                if lengths is None:
                    req.chunks.put((np.asarray(pcm[i]), sr))
                    emitted[i] += int(pcm.shape[1])
                    continue
                # Ship only this sample's remaining valid audio (its own
                # EOS boundary, known per segment), and close its stream as
                # soon as its boundary is final — batchmates may keep going.
                valid = min(max(int(lengths[i]) * hop - emitted[i], 0), int(pcm.shape[1]))
                if valid:
                    req.chunks.put((np.asarray(pcm[i])[:valid], sr))
                    emitted[i] += valid
                if final[i]:
                    if emitted[i] != int(lengths[i]) * hop:
                        # Over-ship is only possible when a final boundary
                        # retro-trims into an earlier chunk (rare; bounded by
                        # the trailing-EOS vote window). Audio already shipped
                        # cannot be retracted — record it instead of crashing.
                        logger.warning(
                            "stream %d emitted %d samples, boundary %d",
                            i, emitted[i], int(lengths[i]) * hop,
                        )
                    req.chunks.put(None)
                    closed[i] = True
        for i, req in enumerate(batch):
            if not closed[i]:
                req.chunks.put(None)

    def _batched_cond_dict(self, batch: list[TTSRequest]) -> dict:
        first = batch[0]
        cond_dict = make_cond_dict(
            text=first.text,
            language=first.language,
            speaker=np.zeros((1, 1, 128), np.float32),
            # Group-key'd scalars: identical across the batch by construction.
            vqscore_8=list(first.vqscore_8) if first.vqscore_8 else [0.78] * 8,
            ctc_loss=first.ctc_loss,
            dnsmos_ovrl=first.dnsmos_ovrl,
            speaker_noised=first.speaker_noised,
            unconditional_keys=first.unconditional_keys,
        )
        # Batched values are injected AFTER make_cond_dict (which normalizes
        # single-sample values to [1, 1, C]).
        cond_dict["espeak"] = ([r.text for r in batch], [r.language for r in batch])
        cond_dict["speaker"] = np.concatenate(
            [
                r.speaker if r.speaker is not None else np.zeros((1, 1, 128), np.float32)
                for r in batch
            ],
            axis=0,
        ).astype(np.float32)
        cond_dict["emotion"] = np.stack(
            [
                np.asarray(
                    r.emotion if r.emotion is not None else cond_dict["emotion"][0, 0],
                    np.float32,
                ).reshape(1, -1)
                for r in batch
            ]
        )
        cond_dict["emotion"] = cond_dict["emotion"] / cond_dict["emotion"].sum(-1, keepdims=True)
        for name, attr in (("fmax", "fmax"), ("pitch_std", "pitch_std"), ("speaking_rate", "speaking_rate")):
            if name in cond_dict:
                cond_dict[name] = np.asarray(
                    [[ [getattr(r, attr)] ] for r in batch], np.float32
                )
        known = set(self.model.conditioner_names)
        return {k: v for k, v in cond_dict.items() if k in known}
