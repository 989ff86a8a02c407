"""Continuous serving engine: requests join and leave one long-lived batched
decode (port of ``zonos_tpu/serving/continuous.py``).

The engine holds a fixed-shape batch of ``slots`` decode lanes (2 x slots
rows with CFG: 16 at the default 8, 32 at 16, one K1-K3 launch each) and
changes membership between segments:

* every request, the first included, enters by ``join``: a batch-size-1
  prefill copied into a free slot (``runtime/continuous.py``);
* a slot is freed as soon as its request's EOS drain completes or its token
  budget is reached (a host ``kill`` at the boundary);
* queued requests are admitted at every segment boundary while the
  delayed-frame timeline has room; when it fills, the epoch drains and a
  fresh one starts.

The machinery is JAX's, with the same ``ZONOS_ENGINE_*`` variables and
defaults:

* **KV timeline compaction and the attend-window ladder**: at boundaries the
  cache's decode region rolls left by the smallest dead gap of the active
  slots, and each segment attends only the smallest rung
  (``ZONOS_ENGINE_ATTEND_QUANTUM``, default 512) covering the live window;
  the delayed-frame timeline rolls too (``ZONOS_ENGINE_FRAME_QUANTUM``);
  ``ZONOS_ENGINE_ROLL=0`` turns both off.
* **Depth-2 dispatch** (``ZONOS_ENGINE_DEPTH``): segment k+1 is queued
  before segment k's status is read, so joins and kills apply one boundary
  late and a joiner's audio base and token budget are confirmed by the next
  status (``_Slot.confirmed``). In the port the host knows a segment's
  offset when it has queued it (the carry's offset is a host int), and the
  engine still takes it from the status, as JAX's does, so a joiner's base
  and budget equal JAX's for the same schedule.
* **One status read per segment**: the engine's segments run without the
  per-step early-exit read (``early_exit=False``); steps after a row's
  drain change none of its codes, lengths or PCM.
* **Pipelined shipping**: the epoch loop plans chunk spans; a shipper thread
  reads the PCM back (int16 unless ``ZONOS_PCM_INT16=0``) and delivers each
  request's chunks in order. PCM ships in fixed quanta of
  ``segment_frames + dac_context_frames`` frames.
* **Conditioning off the loop**: G2P and the conditioner forward run on a
  prep thread. It queues CUDA work on the same stream as the worker, and
  touches no kernel's per-device state (K3's scratch is guarded per stream,
  ``ops/cuda_matmul``).
* **Spans** (``utils/profiling``): the loop records ``engine.dispatch``
  (counters ``rung`` and ``active``), ``engine.mutate`` and
  ``engine.absorb`` (``engine.harvest``, ``engine.status_wait``,
  ``engine.plan``, ``engine.retire``); the prep thread ``prep.run``, the
  shipper ``ship.readback``. A request the server made a ``RequestTrace``
  for is marked as it is queued, prepped, joined, planned and shipped.

Sampling parameters and cfg_scale are per-slot runtime values
(``RuntimeSamplingParams`` and a [B] cfg vector, set at joins), so one epoch
serves requests of different settings, each row sampled as its static solo
run. Only ``top_k`` and the repetition window partition epochs. Every slot
draws from its own request-seeded generator, so a fixed-seed request
reproduces its solo tokens whatever its slot, co-residents or join time.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import queue
import threading
import time

import numpy as np
import torch

from zonos_tpu_torch.ops.delay_pattern import apply_delay_pattern_np
from zonos_tpu_torch.ops.sampling import RuntimeSamplingParams, SamplingParams
from zonos_tpu_torch.runtime.continuous import (
    compiled_continuous_fns,
    compiled_roll_fn,
    compiled_segment_attend,
    compiled_set_sampling_row,
)
from zonos_tpu_torch.runtime.generate import (
    MAX_REP_WINDOW,
    UNKNOWN_TOKEN,
    GenerateStatics,
    _bucket,
    pad_conditioning,
    row_generators,
)
from zonos_tpu_torch.serving import metrics
from zonos_tpu_torch.serving.batcher import DynamicBatcher, TTSRequest
from zonos_tpu_torch.utils import profiling

logger = logging.getLogger("zonos_tpu_torch")

BIG = np.iinfo(np.int32).max


def _req_id(req: TTSRequest) -> int | None:
    return req.trace.id if req.trace is not None else None


def _mark(req: TTSRequest, boundary: str) -> None:
    """The instant ``req`` first reaches a stage boundary (``batcher.STREAM_STAGES``)."""
    if req.trace is not None:
        req.trace.mark(boundary)


def _readback(pcm_dev: torch.Tensor, reqs: list) -> np.ndarray:
    """The blocking PCM readback, recorded for the first request in
    ``reqs`` whose first audio it carries."""
    first = next((r for r in reqs if r.trace is not None and "shipped" not in r.trace.marks), None)
    with profiling.span("ship.readback", req=_req_id(first) if first else None):
        return pcm_dev.cpu().numpy()


@dataclasses.dataclass
class _Slot:
    req: TTSRequest | None = None
    active: bool = False
    # Boundary-confirmed bookkeeping: with depth>1 dispatch the join executes
    # on device after a segment whose status the host has not read yet, so
    # base/need are unknown until that status arrives (confirmed=False).
    confirmed: bool = False
    base: int = 0        # global de-delayed frame where this request's audio starts
    need: int = 0        # global steps_done at which its token budget runs out
    emitted: int = 0     # PCM samples shipped so far
    max_new: int = 0     # token budget (for deferred need computation)
    join_lb: int = 0     # lower bound on the global join step (for roll safety)


class ContinuousEngine:
    """Slot-based continuous batcher around a (transformer) Zonos model."""

    def __init__(
        self,
        model,
        slots: int = 8,
        prefill_len: int = 256,
        max_new_cap: int = 86 * 30,
        segment_frames: int = 64,
        first_chunk_frames: int = 16,
        dac_context_frames: int = 16,
        window_ms: float = 30.0,
    ):
        self.model = model
        self.slots = slots
        n_q = model.config.codebook_dimension
        self.prefill_len = _bucket(prefill_len, 64)
        self.delayed_len = _bucket(max_new_cap + n_q, 512)
        self.cache_len = _bucket(self.prefill_len + (self.delayed_len - 1) + 1, 128)
        self.segment_frames = segment_frames
        self.first_chunk_frames = first_chunk_frames
        self.dac_context_frames = dac_context_frames
        self.window_s = window_ms / 1000.0
        self.depth = max(int(os.environ.get("ZONOS_ENGINE_DEPTH", "2")), 1)
        self.roll_quantum = int(os.environ.get("ZONOS_ENGINE_ROLL_QUANTUM", "64"))
        self.attend_quantum = int(os.environ.get("ZONOS_ENGINE_ATTEND_QUANTUM", "512"))
        # Delayed-frame compaction: cadence + how many frames must remain
        # behind the write offset (default 512 preserves the device
        # EOS-trim window size — min(50, valid//4) saturates at valid ≥ 200
        # — and dwarfs the ≤100-frame repetition window; tests shrink it).
        self.frame_quantum = int(os.environ.get("ZONOS_ENGINE_FRAME_QUANTUM", "512"))
        self.frame_margin = 512
        if os.environ.get("ZONOS_ENGINE_ROLL", "1") != "1":
            self.roll_quantum = BIG  # compaction disabled (A/B escape hatch)
            self.frame_quantum = BIG
        self._queue: "queue.Queue[TTSRequest]" = queue.Queue()
        self._stop = threading.Event()
        # "steps" and "prefills" count what ran on the device (decode steps of
        # every segment, batch starts and joiners' prefills): K1-K3's launch
        # counts follow from them.
        self.stats = {
            "requests": 0, "epochs": 0, "joins": 0, "mid_epoch_joins": 0,
            "slot_recycles": 0, "rolls": 0, "rolled_steps": 0, "rolled_frames": 0,
            "steps": 0, "prefills": 0,
        }

        # PCM ships in fixed-size quanta: every decode has the same shape,
        # and every offset is a runtime value.
        ae = model.autoencoder
        hop = ae.config.hop_length
        W = self.segment_frames + self.dac_context_frames
        F = self.first_chunk_frames
        self._quantum_frames = W
        self._solo_frames = F

        # Device-side int16 quantization (serving default; ZONOS_PCM_INT16=0
        # ships float32).
        int16 = os.environ.get("ZONOS_PCM_INT16", "1") != "0"

        @torch.no_grad()
        def _quantum_pcm(device_codes, lo0, total, starts, bnds):
            """Masked batch PCM for the W-frame window starting at lo0."""
            piece = device_codes[:, :, lo0:lo0 + W]
            fidx = lo0 + torch.arange(W, device=piece.device)
            starts = torch.as_tensor(starts, device=piece.device)
            bnds = torch.as_tensor(bnds, device=piece.device)
            m = ((fidx[None, None, :] < starts[:, None, None]) | (fidx[None, None, :] >= bnds[:, None, None])
                 | (fidx[None, None, :] >= total))
            return ae.decode_device(torch.where(m, 0, piece), to_int16=int16)

        @torch.no_grad()
        def _solo_pcm(device_codes, slot, lo0, total, bnd):
            """One slot's first F frames decoded solo (a joiner's stream start:
            the batched window would feed its pre-base filler as the codec's
            left context; solo from its own base matches a fresh stream)."""
            piece = device_codes[slot:slot + 1, :, lo0:lo0 + F]
            fidx = lo0 + torch.arange(F, device=piece.device)
            m = (fidx[None, None, :] >= bnd) | (fidx[None, None, :] >= total)
            return ae.decode_device(torch.where(m, 0, piece), to_int16=int16)[0]

        self._quantum_pcm = _quantum_pcm
        self._solo_pcm = _solo_pcm
        self._hop = hop
        # Shipping is pipelined off the epoch loop: the loop plans each chunk
        # (span arithmetic and emitted bookkeeping) and a shipper thread does
        # the blocking device-to-host PCM readback and per-request delivery.
        # One shipper keeps each request's chunks in order; maxsize bounds
        # the device buffers in flight.
        self._ship_q: "queue.Queue" = queue.Queue(maxsize=8)
        self._shipper_thread = threading.Thread(target=self._shipper, daemon=True)
        self._shipper_thread.start()
        # Conditioning prep (G2P + conditioner forward) runs on its own
        # thread and feeds the epoch loop pre-prepped requests.
        self._prepped: "queue.Queue[tuple]" = queue.Queue()
        self._prep_thread = threading.Thread(target=self._prep_worker, daemon=True)
        self._prep_thread.start()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------

    def _shipper(self):
        """Drain ship plans: blocking PCM readback + ordered chunk delivery."""
        while True:
            item = self._ship_q.get()
            if item is None:
                return
            kind = item[0]
            if kind == "pcm":
                _, pcm_dev, rows, lo0, sr = item
                pcm = _readback(pcm_dev, [r[0] for r in rows])
                hop = self._hop
                for req, slot, lo, hi in rows:
                    _mark(req, "shipped")
                    req.chunks.put((pcm[slot, (lo - lo0) * hop:(hi - lo0) * hop], sr))
            elif kind == "solo":
                _, pcm_dev, req, lo0, base, hi, sr = item
                pcm = _readback(pcm_dev, [req])
                hop = self._hop
                _mark(req, "shipped")
                req.chunks.put((pcm[(base - lo0) * hop:(hi - lo0) * hop], sr))
            elif kind == "finish":
                self._finish(item[1])
            else:  # flush marker
                item[1].set()

    def _ship_flush(self, timeout: float = 120.0):
        """Wait until every queued ship plan has been delivered."""
        ev = threading.Event()
        self._ship_q.put(("flush", ev))
        ev.wait(timeout)

    # ------------------------------------------------------------------
    # Public API (mirrors DynamicBatcher)
    # ------------------------------------------------------------------

    def submit(self, request: TTSRequest, timeout: float = 600.0):
        """Blocking submit: returns (wav [T], sample_rate). The wav is int16
        under the serving default (quantized on the device; ZONOS_PCM_INT16=0
        for float32); every sink (wav writer, HTTP PCM16) takes both."""
        request.stream = False
        _mark(request, "queued")
        self._queue.put(request)
        deadline = time.monotonic() + timeout
        pieces = []
        sr = self.model.autoencoder.sampling_rate
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError("TTS request timed out")
            try:
                item = request.chunks.get(timeout=remaining)
            except queue.Empty:
                raise TimeoutError("TTS request timed out") from None
            if item is None:
                if request._error is not None:
                    raise request._error
                wav = (
                    np.concatenate(pieces)
                    if pieces else np.zeros((0,), np.float32)
                )
                return wav, sr
            pieces.append(item[0])

    def submit_stream(self, request: TTSRequest, timeout: float = 600.0):
        """Streaming submit: yields (pcm [T] float32, sample_rate) chunks."""
        request.stream = True
        _mark(request, "queued")
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
        self._prep_thread.join(timeout=10)
        self._thread.join(timeout=10)
        self._ship_q.put(None)
        self._shipper_thread.join(timeout=10)

    # ------------------------------------------------------------------

    @staticmethod
    def _finish(req: TTSRequest, error: Exception | None = None):
        """Queue a request's terminal None exactly once (success or error)."""
        if error is not None:
            req._error = error
        req._finished = True
        req.chunks.put(None)

    @staticmethod
    def _epoch_key(req: TTSRequest) -> tuple:
        # Only STRUCTURAL sampling params partition epochs; everything else
        # (temperature/top_p/min_p/unified/penalty value/cfg_scale) is a
        # runtime per-slot value. A request with penalty == 1.0 never reads
        # its window (the runtime penalty is an exact identity), so it maps
        # to the default window and shares the common epoch. no_batch
        # requests get a private epoch (pure isolation escape hatch).
        solo = id(req) if req.no_batch else None
        sp = req.sampling
        if sp.repetition_penalty == 1.0:
            window = SamplingParams().repetition_penalty_window
        else:
            window = min(sp.repetition_penalty_window, MAX_REP_WINDOW)
        return (sp.top_k, window, solo)

    def _statics(self, req: TTSRequest) -> GenerateStatics:
        top_k, window, _solo = self._epoch_key(req)
        return GenerateStatics(
            cfg=self.model.config,
            sampling=SamplingParams(top_k=top_k, repetition_penalty_window=window),
            prefill_len=self.prefill_len,
            delayed_len=self.delayed_len,
            cache_len=self.cache_len,
            batch_size=self.slots,
            kv_int8=bool(self.model.default_kv_int8),
            runtime_sampling=True,
        )

    def _prep(self, req: TTSRequest):
        """Host-side conditioning prep → (cond [2, Lc, D], pad) or None if
        the request cannot fit this engine's prefill bucket."""
        cond_dict = DynamicBatcher._batched_cond_dict(
            _SingleView(self.model), [req]
        )
        # Stays on the device: the shape is known without a readback, and
        # pad_conditioning and the b1 prefill chain on the device.
        cond = self.model.prepare_conditioning(cond_dict, cfg_scale=req.cfg_scale)
        t0 = int(cond.shape[1]) + 1
        if t0 > self.prefill_len:
            return None
        return cond, self.prefill_len - t0

    def _prep_worker(self):
        """Conditioning prep off the epoch loop: G2P and the conditioner
        forward overlap the in-flight decode segments instead of stretching a
        boundary. Prepped requests flow to the epoch loop via _prepped."""
        n_q = self.model.config.codebook_dimension
        while not self._stop.is_set():
            try:
                req = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                if req.max_new_tokens + n_q + 3 > self.delayed_len:
                    self._finish(req, error=ValueError(
                        f"max_new_tokens {req.max_new_tokens} exceeds engine "
                        f"capacity {self.delayed_len - n_q - 3}"
                    ))
                    continue
                with profiling.span("prep.run", req=_req_id(req)):
                    prep = self._prep(req)
                if prep is None:
                    self._finish(req, error=ValueError(
                        f"conditioning too long for engine prefill bucket "
                        f"{self.prefill_len}"
                    ))
                    continue
                _mark(req, "prepped")
                self._prepped.put((req, prep))
            except Exception as e:  # pragma: no cover - defensive
                self._finish(req, error=e)

    def _worker(self):
        while not self._stop.is_set():
            try:
                first, first_prep = self._prepped.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                self._run_epoch(first, first_prep)
            except Exception as e:  # pragma: no cover - defensive
                logger.exception("continuous epoch failed")
                # _run_epoch errors out every request it knows about. Only
                # poison `first` if IT never reached a terminal state — it
                # may have completed successfully earlier in the epoch, and
                # its consumer might not have drained the queue yet.
                if not first._finished:
                    self._finish(first, error=e)

    # ------------------------------------------------------------------

    def _attend_rung(self, segend_dev: int) -> int:
        """Smallest attend window of the ladder covering write indices through
        ``segend_dev`` device steps (write_index max = P + segend_dev − 1)."""
        return min(
            self.cache_len,
            self.prefill_len + _bucket(max(segend_dev, 1), self.attend_quantum),
        )

    def _run_epoch(self, first: TTSRequest, first_prep=None):
        """One batch lifetime: all-dummy start → joins/leaves → drain."""
        model = self.model
        cfg = model.config
        n_q = cfg.codebook_dimension
        ae = model.autoencoder
        hop = ae.config.hop_length
        sr = ae.sampling_rate
        key = self._epoch_key(first)
        statics = self._statics(first)
        start, _segment, prefill_b1, join, kill = compiled_continuous_fns(statics)
        roll = compiled_roll_fn(statics)
        set_row = compiled_set_sampling_row()
        self.stats["epochs"] += 1

        B, P, S = self.slots, self.prefill_len, self.delayed_len
        d = cfg.backbone.d_model

        # All-dummy start: zero conditioning, every slot killed; requests
        # only ever enter through join (uniform path).
        dev = model.device
        zero_cond = torch.zeros((2 * B, P, d), dtype=model.dtype, device=dev)
        delayed0 = torch.as_tensor(apply_delay_pattern_np(
            np.full((B, n_q, S - n_q), UNKNOWN_TOKEN, np.int32), cfg.masked_token_id
        ), device=dev)
        pad_amount = torch.full((2 * B,), P - 1, dtype=torch.int32, device=dev)
        pos_offset = torch.zeros((2 * B,), dtype=torch.int32, device=dev)
        gap_len = torch.zeros((2 * B,), dtype=torch.int32, device=dev)
        # Per-slot runtime sampling params + cfg scales (joiners overwrite
        # their row; dummy rows sample under `first`'s params into killed
        # lanes, where nothing ships).
        rt_dev = RuntimeSamplingParams.from_static(first.sampling, B, device=dev)
        cfg_vec = torch.full((B,), float(first.cfg_scale), dtype=torch.float32, device=dev)
        with torch.no_grad():
            carry, status, _ = start(
                model.params, zero_cond, delayed0, 1, pad_amount, cfg_vec,
                row_generators(int(first.seed) & 0x7FFFFFFF, B, dev), 0, 0, rt_params=rt_dev,
            )
        self.stats["prefills"] += 1
        for i in range(B):
            carry = kill(carry, i, 0)

        slot_states = [_Slot() for _ in range(B)]
        if first_prep is None:  # direct callers / tests: prep inline
            first_prep = self._prep(first)
            if first_prep is None:
                self._finish(first, error=ValueError(
                    f"conditioning too long for engine prefill bucket {P}"
                ))
                return
        pending: list[tuple] = [(first, first_prep)]  # (req, (cond, pad))
        ready: list[tuple] = []  # (req, c1, pad, rt1, prep)
        emitted_global = 0
        # Confirmed (last-read-status) global coordinates. ``rolled`` is the
        # cumulative KV compaction: device steps = global steps − rolled.
        offset, steps_g = int(status[0].item()), 0
        rolled = 0
        frolled = 0  # cumulative delayed-FRAME compaction (global = device + frolled)
        segend_g = 0  # global segment_end of the most recently dispatched segment
        # In-flight dispatched-but-unread segments:
        # (status, codes, rolled_at_dispatch, confirm_slots) — confirm_slots
        # are joiners whose boundary state this status reveals.
        pipeline: list[tuple] = []
        just_joined = False
        stall = 0

        def free_slots():
            return [i for i, s in enumerate(slot_states) if not s.active]

        @profiling.traced("engine.harvest")
        def harvest():
            """Admission phase 1 — everything that does NOT need boundary
            state: drain the PREPPED queue (conditioning/G2P already done by
            _prep_worker, off this loop) and dispatch the batch-size-1
            prefill. Called while decode segments are in flight, so the
            prefill queues behind them and overlaps the host's readback."""
            deadline = time.monotonic() + (
                self.window_s if not any(s.active for s in slot_states) else 0.0
            )
            while True:
                try:
                    timeout = max(deadline - time.monotonic(), 0.0)
                    item = (
                        self._prepped.get(timeout=timeout)
                        if timeout else self._prepped.get_nowait()
                    )
                    pending.append(item)
                except queue.Empty:
                    break
            keep: list[tuple] = []
            for req, prep in pending:
                if self._epoch_key(req) != key or len(ready) >= B:
                    keep.append((req, prep))
                    continue
                cond, pad = prep
                rt1 = RuntimeSamplingParams.from_static(req.sampling, 1, device=dev)
                with torch.no_grad():
                    c1 = prefill_b1(
                        model.params, pad_conditioning(cond, pad, model.dtype, dev), delayed0[:1], 1,
                        torch.full((2,), pad, dtype=torch.int32, device=dev), float(req.cfg_scale),
                        row_generators(int(req.seed) & 0x7FFFFFFF, 1, dev), rt_params=rt1,
                    )
                self.stats["prefills"] += 1
                ready.append((req, c1, pad, rt1, prep))
            pending[:] = keep

        @profiling.traced("engine.mutate")
        def mutate():
            """Between-segment device mutations: KV compaction, then joins.
            All queue on the device stream after the last dispatched segment;
            with depth>1 the host has not read that segment's status yet, so
            every decision here uses only confirmed state + safe bounds."""
            nonlocal carry, pos_offset, gap_len, pad_amount, just_joined, rolled
            nonlocal rt_dev, cfg_vec, frolled

            # KV roll: the span [P, P + m) is dead for every active slot when
            # m ≤ each one's join step (joins only ever happen at or after
            # the confirmed step at their dispatch, so join_lb is a safe
            # lower bound for not-yet-confirmed joiners). m ≤ confirmed
            # steps keeps the roll inside the written region.
            #
            # Delayed-FRAME roll: the first r frames of the audio timeline
            # are discardable once shipped and outside every consumer's
            # reach — r ≤ emitted − dac_context (quantum decode left
            # context), r ≤ offset − 512 (covers the ≤100-frame repetition
            # window AND keeps the device EOS-trim search window at its
            # solo size). Without it the finite delayed_len caps epoch
            # lifetime: offset hits the 30 s allocation, admission stalls,
            # occupancy decays, and the epoch restarts.
            active = [st for st in slot_states if st.active]
            if active and self.roll_quantum < BIG:
                m = min(min(st.join_lb for st in active), steps_g) - rolled
                r = min(
                    emitted_global - self.dac_context_frames,
                    offset - self.frame_margin,
                ) - frolled
                r = max(r, 0)
                if m >= self.roll_quantum or r >= self.frame_quantum:
                    carry, pos_offset, gap_len = roll(carry, max(m, 0), pos_offset, gap_len, r)
                    rolled += max(m, 0)
                    frolled += r
                    self.stats["rolls"] += 1
                    self.stats["rolled_steps"] += max(m, 0)
                    self.stats["rolled_frames"] += r

            admitted = False
            keep: list[tuple] = []
            for req, c1, pad, rt1, prep in ready:
                free = free_slots()
                # Capacity: the join executes at a boundary offset the host
                # has not read yet; bound it by confirmed offset + frames
                # already dispatched beyond the confirmed step. Capacity is
                # judged in DEVICE frame coordinates — the frame roll keeps
                # reclaiming the shipped head of the timeline.
                offset_ub = offset + max(segend_g - steps_g, 0)
                cap_need = (offset_ub - frolled) + req.max_new_tokens + n_q + 1
                if not free or cap_need > S:
                    # No slot, or timeline nearly full: next boundary/epoch.
                    keep.append((req, c1, pad, rt1, prep))
                    continue
                slot = free[0]
                _mark(req, "joined")
                carry, pos_offset, gap_len, pad_amount = join(
                    carry, c1, slot, pos_offset, gap_len, pad_amount, (pad, pad),
                )
                rt_dev, cfg_vec = set_row(rt_dev, cfg_vec, slot, rt1, req.cfg_scale)
                st = slot_states[slot]
                if st.req is not None:
                    self.stats["slot_recycles"] += 1
                new = _Slot(
                    req=req, active=True, emitted=0,
                    max_new=req.max_new_tokens, join_lb=steps_g,
                )
                if pipeline:
                    # Boundary state arrives with the last dispatched
                    # segment's status; defer base/need until then.
                    pipeline[-1][4].append(slot)
                else:
                    new.confirmed = True
                    new.base = offset - 2
                    new.need = steps_g + req.max_new_tokens + n_q - 2
                slot_states[slot] = new
                self.stats["requests"] += 1
                self.stats["joins"] += 1
                if steps_g > 0:
                    self.stats["mid_epoch_joins"] += 1
                admitted = True
            ready[:] = keep
            if admitted:
                just_joined = True
                metrics.observe_batch(sum(s.active for s in slot_states))

        def dispatch():
            """Queue the next decode segment (smallest covering attend rung)."""
            nonlocal carry, segend_g, just_joined
            quiet = (
                self._queue.empty() and self._prepped.empty()
                and not pending and not ready
            )
            # A short first segment buys the joiner fast first audio, but
            # every segment pays the same fixed boundary cost; under load
            # joins happen at almost every boundary, so shrink only when
            # nobody else is waiting (JAX's rule).
            seg = (
                self.first_chunk_frames
                if just_joined and quiet and len(pipeline) == 0
                else self.segment_frames
            )
            just_joined = False
            segend_g = max(segend_g, steps_g) + seg
            # Global stop: the max token budget across lanes. Unconfirmed
            # joiners' needs are bounded by segend_g (they join no later
            # than the last dispatched boundary) + their budget.
            max_need = 0
            for st in slot_states:
                if not st.active:
                    continue
                max_need = max(
                    max_need,
                    st.need if st.confirmed else segend_g + st.max_new + n_q - 2,
                )
            rung = self._attend_rung(segend_g - rolled)
            segment = compiled_segment_attend(statics, rung)
            steps_before = carry.steps_done
            with profiling.span("engine.dispatch", rung=rung,
                                active=sum(st.active for st in slot_states)), torch.no_grad():
                carry, st_dev, codes_dev = segment(
                    model.params, carry, pad_amount, cfg_vec, max_need - rolled, segend_g - rolled,
                    pos_offset, gap_len, rt_dev, early_exit=False,
                )
            self.stats["steps"] += carry.steps_done - steps_before
            pipeline.append((st_dev, codes_dev, rolled, frolled, []))

        @profiling.traced("engine.absorb")
        def absorb():
            """Read the oldest in-flight segment's status; ship PCM; retire
            slots; confirm joiners whose boundary this status reveals."""
            nonlocal offset, steps_g, emitted_global, carry, stall
            status_dev, device_codes, rolled_snap, frolled_snap, confirm_slots = pipeline.pop(0)
            # Overlap admission host work (queue drain, G2P prep, prefill
            # dispatch) with the in-flight segments…
            harvest()
            # …then block on the segment's status readback. Every frame
            # quantity the device reports is in its ROLLED coordinates; the
            # per-dispatch frolled snapshot converts to the host's GLOBAL
            # frame timeline (the step analogue is rolled_snap).
            with profiling.span("engine.status_wait"):
                sv = status_dev.cpu().numpy()
            t_plan = time.perf_counter_ns()
            new_offset = int(sv[0]) + frolled_snap
            steps_dev = int(sv[1])
            progressed = new_offset > offset
            offset = new_offset
            steps_g = steps_dev + rolled_snap
            lengths = sv[3 : 3 + B].astype(np.int64) + frolled_snap
            drained = sv[3 + B :].astype(bool)

            total = max(offset - n_q, 0)
            # Mask each slot's codes outside its OWN audio span before the
            # codec sees them: positions before a joiner's base hold its
            # rolled prefill row's sanitized filler (not audio), positions
            # past a drained slot's boundary hold sanitized post-EOS codes,
            # and positions past `total` are unsettled. Slots whose join
            # boundary is not yet confirmed ship nothing (their base is
            # provably past `total` — audio settles only after n_q more
            # steps than the join boundary).
            starts_np = np.asarray(
                [st.base - frolled_snap if st.confirmed else BIG
                 for st in slot_states],
                np.int32,
            )
            drained_live = np.asarray([
                bool(drained[i]) and st.active and st.confirmed
                for i, st in enumerate(slot_states)
            ])
            bnds_np = np.where(
                drained_live, lengths - frolled_snap, BIG
            ).astype(np.int32)

            def slot_bound(i, st):
                # A slot never ships past its OWN token budget (global
                # offset = 2 + steps, so its frame cap is need + 2 - n_q
                # = base + max_new) even when a batchmate keeps the loop
                # running past it.
                cap = st.need + 2 - n_q
                return int(lengths[i]) if drained_live[i] else min(total, cap)

            # The timeline ships in FULL segment_frames quanta (static
            # shapes — see __init__), plus one partial flush when a slot
            # retires this round (its tail must complete now) up to the
            # farthest retiring bound.
            flush_to = 0
            for i, st in enumerate(slot_states):
                if not st.active or not st.confirmed:
                    continue
                if drained_live[i] or steps_g >= st.need:
                    flush_to = max(flush_to, slot_bound(i, st))
            W = self.segment_frames
            WQ = self._quantum_frames
            S_codes = int(device_codes.shape[2])
            total32 = np.int32(min(total - frolled_snap, S_codes))

            quanta = []  # (qlo, qhi, lo0 GLOBAL, device pcm) — dispatched, unread
            q = emitted_global
            while True:
                if total - q >= W:
                    qhi = q + W
                elif flush_to > q:
                    qhi = min(flush_to, total)
                else:
                    break
                lo0_dev = min(
                    max(q - self.dac_context_frames - frolled_snap, 0),
                    S_codes - WQ,
                )
                pcm = self._quantum_pcm(
                    device_codes, np.int32(lo0_dev), total32, starts_np, bnds_np
                )
                quanta.append((q, qhi, lo0_dev + frolled_snap, pcm))
                q = qhi

            # A mid-epoch joiner's FIRST piece: decode its opening
            # first_chunk_frames solo as soon as they settle, without
            # waiting for the global quanta to reach its base —
            # streaming TTFA stays one segment.
            F = self._solo_frames
            solos = []  # (slot index, lo, hi, device pcm)
            for i, st in enumerate(slot_states):
                if not st.active or not st.confirmed or st.emitted > 0 or st.base < q:
                    continue
                bound = slot_bound(i, st)
                hi = min(st.base + F, bound, total)
                if hi <= st.base:
                    continue
                if hi - st.base < F and not (drained_live[i] or hi == bound):
                    continue  # wait until a full F (or the stream's end)
                lo0_dev = min(st.base - frolled_snap, S_codes - F)
                pcm = self._solo_pcm(
                    device_codes, np.int32(i), np.int32(lo0_dev), total32,
                    np.int32(bound - frolled_snap),
                )
                solos.append((i, lo0_dev + frolled_snap, hi, pcm))

            # PLAN shipping synchronously (span arithmetic + emitted
            # bookkeeping stay on this thread, so the next boundary's
            # decisions never race), then hand the blocking PCM readback +
            # chunk delivery to the shipper thread. A quantum's per-slot
            # spans bind the REQUEST object, not the slot — the slot may be
            # recycled before the readback lands.
            hop_ = self._hop
            for qlo, qhi, lo0, pcm_dev in quanta:
                rows = []
                for i, st in enumerate(slot_states):
                    if not st.active or not st.confirmed:
                        continue
                    shipped = st.base + st.emitted // hop_
                    lo = max(shipped, qlo)
                    hi = min(slot_bound(i, st), qhi)
                    if hi > lo:
                        rows.append((st.req, i, lo, hi))
                        st.emitted += (hi - lo) * hop_
                if rows:
                    for req, *_ in rows:
                        _mark(req, "planned")
                    self._ship_q.put(("pcm", pcm_dev, rows, lo0, sr))
            emitted_global = q
            for i, lo0, hi, pcm_dev in solos:
                st = slot_states[i]
                _mark(st.req, "planned")
                self._ship_q.put(("solo", pcm_dev, st.req, lo0, st.base, hi, sr))
                st.emitted += (hi - st.base) * hop_
            t_retire = time.perf_counter_ns()
            profiling.record("engine.plan", t_plan, t_retire)

            # Retire slots: EOS drained, or token budget exhausted. The
            # terminal None routes through the shipper so it lands AFTER
            # the request's final chunk.
            n_retired = 0
            for i, st in enumerate(slot_states):
                if not st.active or not st.confirmed:
                    continue
                if drained_live[i]:
                    expect = max(int(lengths[i]) - st.base, 0) * hop
                    if st.emitted != expect:
                        logger.warning(
                            "slot %d emitted %d samples, boundary %d",
                            i, st.emitted, expect,
                        )
                    self._ship_q.put(("finish", st.req))
                    st.active = False
                    n_retired += 1
                elif steps_g >= st.need:
                    # Token budget exhausted: cap at the exhaustion rule.
                    # stop_at = need + 2 makes the device vote report
                    # exactly base + max_new frames (solo-equivalent cap)
                    # even if segments overshot its boundary; the chunk
                    # above already shipped up to that cap. With depth>1
                    # the kill lands one boundary late — the slot decodes
                    # junk past its budget for ≤1 segment, none of which
                    # ships (slot_bound caps at `cap`).
                    carry = kill(carry, i, st.need + 2 - frolled)
                    self._ship_q.put(("finish", st.req))
                    st.active = False
                    n_retired += 1

            # Confirm joiners whose boundary state this status reveals: the
            # join executed on device right after this segment, at exactly
            # this offset/step.
            for i in confirm_slots:
                st = slot_states[i]
                if not st.active:  # errored epoch teardown already handled it
                    continue
                st.confirmed = True
                st.base = offset - 2
                st.need = steps_g + st.max_new + n_q - 2
                st.join_lb = steps_g

            # Stall guard: active confirmed slots but no timeline progress
            # for several consecutive statuses means the device loop cannot
            # advance (e.g. delayed-timeline capacity bug) — fail the epoch
            # rather than spin forever.
            if progressed or n_retired:
                stall = 0
            elif any(st.active and st.confirmed for st in slot_states):
                stall += 1
                if stall > 2 * self.depth + 2:
                    raise RuntimeError(
                        f"engine stalled: offset={offset} steps={steps_g} "
                        f"active={sum(s.active for s in slot_states)}"
                    )
            profiling.record("engine.retire", t_retire, time.perf_counter_ns())

        try:
            harvest()
            while True:
                # Top up the dispatch pipeline: mutations (roll/joins) queue
                # between segments, then the next segment goes out BEFORE
                # any in-flight status is read.
                while len(pipeline) < self.depth:
                    mutate()
                    if not any(st.active for st in slot_states):
                        break
                    dispatch()
                if not pipeline:
                    if any(st.active for st in slot_states) or ready:
                        # Active-but-undispatchable cannot happen (dispatch
                        # follows mutate whenever a slot is active); ready
                        # without capacity seeds the next epoch.
                        if any(st.active for st in slot_states):
                            raise RuntimeError("engine: active slots but no dispatch")
                    break
                absorb()
        except Exception as e:
            # Drain the shipper first: queued chunks/finishes for already-
            # completed requests must land BEFORE any error terminal (a
            # success-finish arriving after an error-finish would be
            # misordered for its consumer).
            try:
                self._ship_flush()
            except Exception:  # pragma: no cover - teardown best-effort
                pass
            for st in slot_states:
                if st.active and st.req is not None:
                    self._finish(st.req, error=e)
                    st.active = False
            for req, _c1, _pad, _rt1, _prep in ready:
                self._finish(req, error=e)
            ready.clear()
            # Requests still in `pending` never entered this epoch — the
            # wrong-key ones are innocent bystanders; only same-key requests
            # (which would have joined this epoch's batch) share its failure.
            for req, prep in pending:
                if self._epoch_key(req) == key:
                    self._finish(req, error=e)
                else:
                    self._prepped.put((req, prep))
            pending.clear()
            raise

        # Epoch over: anything still pending or prepared-but-unjoined
        # (wrong key / out of capacity) seeds the next epoch.
        for req, _c1, _pad, _rt1, prep in ready:
            self._prepped.put((req, prep))
        for req, prep in pending:
            self._prepped.put((req, prep))


class _SingleView:
    """Minimal shim so DynamicBatcher._batched_cond_dict can be reused for a
    single request (it only touches .model.conditioner_names)."""

    def __init__(self, model):
        self.model = model
