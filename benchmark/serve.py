"""Server wrapper: ``zonos_tpu_torch.serving.server.main`` in this process,
fed the seeded weights and watched from the outside.

    python -m benchmark.serve --config C --seed S --work DIR --control-port P
        [--trace] [--platform cpu] -- <server arguments>

Before the server starts, the wrapper writes what the server reads into its
working directory ``DIR`` (``configmodel.txt``, the voices under
``speakers/en``, the checkpoint and hub-cache file names) and makes the
weights on the device from the seed (``benchmark.weights``). The checkpoint
files are empty: the program's file readers (``utils.safetensors_io.load_file``
and the speaker tower's ``_load_state_dict``) get the tensors from memory, so
a run writes no 3 GB checkpoint to disk, and everything after the read
(conversion, int8 quantization, kernel builds, warm-up) is the program's own.

It records, from its own code around calls into the program: the phoneme ids
the text front end made, every DAC decode's codes and PCM, the PCM each
request was sent, when each /stream request arrived and when its first chunk
went to the HTTP layer, and the continuous engine's counters; and a checksum
of the weights it made (``weight_checksum``). With ``--trace`` it
also opens ``record_function`` ranges (and keeps their host times) around
the engine's segment dispatch and conditioning prep, the decode segments and
prefills of the request loops, ``pipeline.tts``, the codec's decode and the
HTTP handlers, marks the host time at which each decode step starts (the
backbone's one-frame forward, ``streaming._decode_logits``), and runs
``torch.profiler`` when asked. The harness talks to
it on a control port of its own (``/bench/*``, JSON).
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import threading
import time
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from benchmark import isolation  # noqa: E402
from benchmark.weights import checksum, make_voice, make_weights  # noqa: E402

DAC_REPO = "descript/dac_44khz"
SPEAKER_REPO = "Zyphra/Zonos-v0.1-speaker-embedding"
SPEAKER_FILES = ("ResNet293_SimAM_ASP_base.pt", "ResNet293_SimAM_ASP_base_LDA-128.pt")
HOP = 512
_KEY_W = np.random.default_rng(12345).integers(1, 2**20, size=HOP).astype(np.int64)


class Watch:
    """What the wrapper records, and the thread that owns the profiler (it
    must be started and stopped from one thread, and the control server
    answers each request on a new one)."""

    def __init__(self):
        import queue

        self.lock = threading.Lock()
        self.recording = False
        self.records: list = []  # (codes [B, n_q, T] int32, pcm [B, T·hop] int16), on the device
        self.sent: dict = {}  # bench_id → list of PCM byte chunks as sent
        self.handed: dict = {}  # bench_id → when its first chunk went to the HTTP layer (perf_counter s; None before)
        self.phonemes: dict = {}  # text → phoneme ids (left-padded as the model saw them)
        self.engine = None
        self.ranges: list = []  # (name, thread, start ns, end ns) of every ranged call
        self.steps: list = []  # host ns at which each decode step started
        self.prof = None
        self.prof_marks: dict = {}
        self._cmds: "queue.Queue" = queue.Queue()
        self._done: "queue.Queue" = queue.Queue()
        threading.Thread(target=self._profiler_loop, daemon=True).start()

    def on_profiler_thread(self, fn):
        """``fn(self)`` run on the profiler's thread; its result or exception."""
        self._cmds.put(fn)
        ok, value = self._done.get()
        if not ok:
            raise value
        return value

    def _profiler_loop(self):
        while True:
            fn = self._cmds.get()
            try:
                self._done.put((True, fn(self)))
            except Exception as e:  # noqa: BLE001 - handed to the caller
                self._done.put((False, e))


def _put(path: str, data: bytes) -> None:
    """Writes a file whole: the backends of a fleet write the same files into
    one working directory at once, and none may read another's half-written one."""
    tmp = f"{path}.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def _write_setup(work: str, doc: dict, seed: int) -> dict:
    """configmodel.txt, voices and the empty checkpoint files; returns path → loader key.
    The checkpoint's key in configmodel.txt is the configuration's ``path_key``,
    or the Zonos-v0.1 key its ``model_choice`` implies."""
    os.makedirs(work, exist_ok=True)
    model_dir = os.path.join(work, "model")
    os.makedirs(model_dir, exist_ok=True)
    _put(os.path.join(model_dir, "config.json"), json.dumps(doc["config"]).encode())
    key = doc.get("path_key") or f"PATH_MODEL_{'HYBRID' if 'hybrid' in doc['model_choice'] else 'TRANSFORMER'}"
    _put(os.path.join(work, "configmodel.txt"),
         f"{key} = {model_dir}\nPATH_NEEDED_HFHOME = {os.path.join(work, 'hf')}\n".encode())
    files = {os.path.join(model_dir, "model.safetensors"): "zonos"}
    for repo, names, keys in ((DAC_REPO, ("model.safetensors",), ("dac",)),
                              (SPEAKER_REPO, SPEAKER_FILES, ("speaker", "lda"))):
        snap = os.path.join(work, "hf", "hub", f"models--{repo.replace('/', '--')}", "snapshots", "bench")
        os.makedirs(snap, exist_ok=True)
        for name, key in zip(names, keys):
            files[os.path.join(snap, name)] = key
    for path in files:
        open(path, "ab").close()
    voices = os.path.join(work, "speakers", "en")
    os.makedirs(voices, exist_ok=True)
    for i in range(doc["voices"]):
        pcm = make_voice(seed, i, sr=doc["speaker"]["sample_rate"])
        buf = io.BytesIO()
        with wave.open(buf, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(doc["speaker"]["sample_rate"])
            w.writeframes(pcm.tobytes())
        _put(os.path.join(voices, f"npc{i}.wav"), buf.getvalue())
    return {os.path.realpath(p): k for p, k in files.items()}


def _ranged(w: Watch, name: str, fn):
    import torch

    def inner(*a, **k):
        t0 = time.perf_counter_ns()
        try:
            with torch.profiler.record_function(name):
                return fn(*a, **k)
        finally:
            # Kept whether or not the profiler runs: a call that opens before
            # the slice or closes after it still names the host's work in it.
            w.ranges.append((name, threading.get_ident(), t0, time.perf_counter_ns()))
    return inner


def _install(w: Watch, files: dict, weights: dict, trace: bool, fault: str) -> None:
    import torch

    from zonos_tpu_torch.codec import dac as dac_mod
    from zonos_tpu_torch.conditioning import conditioners, espeak
    from zonos_tpu_torch.runtime import streaming
    from zonos_tpu_torch.serving import continuous, server
    from zonos_tpu_torch.speaker import embedding
    from zonos_tpu_torch.utils import loading, safetensors_io

    # The checkpoint reads: the seeded tensors instead of the empty files.
    orig_load = safetensors_io.load_file

    def take(path):
        # Handed over once: the program holds the tensors until it has
        # converted them, and nothing here keeps them alive after that.
        return weights.pop(files[os.path.realpath(str(path))])

    def load_file(path, *a, **k):
        return take(path) if os.path.realpath(str(path)) in files else orig_load(path, *a, **k)

    safetensors_io.load_file = load_file
    loading.load_file = load_file
    orig_sd = embedding._load_state_dict
    embedding._load_state_dict = lambda path: take(path) if os.path.realpath(str(path)) in files else orig_sd(path)

    # Taps: phoneme ids per text, DAC decodes, PCM sent per request, the engine.
    orig_phonemize, orig_tokenize = espeak.phonemize, conditioners.tokenize_phonemes
    local = threading.local()

    def phonemize(texts, languages):
        local.texts = list(texts)
        return orig_phonemize(texts, languages)

    def tokenize(phonemes):
        ids, lens = orig_tokenize(phonemes)
        for t, row in zip(getattr(local, "texts", []), ids):
            w.phonemes[t] = [int(v) for v in row]
        return ids, lens

    espeak.phonemize = phonemize
    conditioners.tokenize_phonemes = tokenize

    orig_decode = dac_mod.DACAutoencoder.decode_device

    def decode_device(self, codes, to_int16=False):
        out = orig_decode(self, codes, to_int16=to_int16)
        if fault == "pcm":
            # A planted fault for the harness's tests: the codec's answer
            # altered where it is produced (every sample halved).
            out = (out.float() * 0.5).to(out.dtype)
        if w.recording:
            with w.lock:
                w.records.append((torch.as_tensor(codes).to(out.device, torch.int32).clone(), out))
        return out

    dac_mod.DACAutoencoder.decode_device = _ranged(w, "codec.decode", decode_device) if trace else decode_device

    orig_stream, orig_generate = server.handle_stream, server.handle_generate

    def handle_stream(body):
        # On the host's monotonic clock (perf_counter), which the load
        # generator's process reads too.
        rid = int(body["bench_id"]) if "bench_id" in body else None
        if rid is not None:
            w.handed[rid] = None
        chunks = []
        for data, sr in orig_stream(body):
            if not chunks and rid is not None:
                w.handed[rid] = time.perf_counter()
            chunks.append(data)
            yield data, sr
        if "bench_id" in body:
            w.sent[int(body["bench_id"])] = chunks

    def handle_generate(body):
        wav_bytes, meta = orig_generate(body)
        if "bench_id" in body:
            with wave.open(io.BytesIO(wav_bytes)) as wf:
                w.sent[int(body["bench_id"])] = [wf.readframes(wf.getnframes())]
        return wav_bytes, meta

    server.handle_stream = handle_stream
    server.handle_generate = _ranged(w, "http.generate", handle_generate) if trace else handle_generate

    orig_init = continuous.ContinuousEngine.__init__

    def engine_init(self, *a, **k):
        orig_init(self, *a, **k)
        w.engine = self

    continuous.ContinuousEngine.__init__ = engine_init

    if fault == "token":
        # A planted fault for the harness's tests: served tokens altered where
        # the sampler produces them (about one in a hundred).
        from zonos_tpu_torch.ops import sampling

        from zonos_tpu_torch.runtime import continuous as rt_continuous

        for mod in (sampling, streaming, rt_continuous):
            for name in ("sample_from_logits", "sample_from_logits_runtime"):
                if hasattr(mod, name):
                    orig = getattr(mod, name)

                    def altered(*a, _orig=orig, **k):
                        tok = _orig(*a, **k)
                        return torch.where(tok % 97 == 5, tok + 1, tok)
                    setattr(mod, name, altered)

    if trace:
        step = streaming._decode_logits

        def decode_step(*a, **k):
            w.steps.append(time.perf_counter_ns())
            return step(*a, **k)

        streaming._decode_logits = decode_step
        seg = continuous.compiled_segment_attend
        continuous.compiled_segment_attend = lambda *a, **k: _ranged(w, "engine.segment_dispatch", seg(*a, **k))
        continuous.ContinuousEngine._prep = _ranged(w, "engine.prep", continuous.ContinuousEngine._prep)
        bseg, bpre = streaming.build_segment_fn, streaming.build_prefill_fn
        streaming.build_segment_fn = lambda *a, **k: _ranged(w, "decode.segment", bseg(*a, **k))
        streaming.build_prefill_fn = lambda *a, **k: _ranged(w, "decode.prefill", bpre(*a, **k))
        server.tts = _ranged(w, "pipeline.tts", server.tts)


def _frame_keys(pcm: np.ndarray) -> np.ndarray:
    n = pcm.shape[-1] // HOP
    return (pcm[..., : n * HOP].reshape(*pcm.shape[:-1], n, HOP).astype(np.int64) * _KEY_W).sum(-1)


def served_codes(w: Watch, ids: list) -> dict:
    """bench_id → {"codes": [n_q][n] of the frames it was sent, "chunks": frame
    counts of its pieces, "unmatched": frames found in no decode, "windows":
    the codes [n_q][T] of each decode row that produced some of its frames,
    "where": [window, frame] of each sent frame in them ([-1, -1] where
    unmatched)}, by matching each sent 512-sample frame to the decode that
    produced it."""
    import torch

    index = {}
    with w.lock:
        records = list(w.records)
    for ri, (codes, pcm) in enumerate(records):
        if pcm.dtype != torch.int16:
            pcm = torch.clamp(pcm * 32767.0, -32767.0, 32767.0).to(torch.int16)
        keys = _frame_keys(pcm.cpu().numpy())
        for b in range(keys.shape[0]):
            for f, k in enumerate(keys[b]):
                index.setdefault(int(k), (ri, b, f))
    out = {}
    for rid in ids:
        chunks = w.sent.get(int(rid))
        if chunks is None:
            continue
        pcm = np.frombuffer(b"".join(chunks), "<i2")
        cols, unmatched, windows, where = [], 0, {}, []
        for k in _frame_keys(pcm):
            hit = index.get(int(k))
            if hit is None:
                unmatched += 1
                cols.append(None)
                where.append([-1, -1])
                continue
            ri, b, f = hit
            cols.append(records[ri][0][b, :, f].cpu().numpy())
            where.append([windows.setdefault((ri, b), len(windows)), f])
        n_q = next((c.shape[0] for c in cols if c is not None), 9)
        codes = np.stack([c if c is not None else np.full(n_q, -1) for c in cols], axis=1) if cols else \
            np.zeros((n_q, 0), np.int64)
        out[str(rid)] = {"codes": codes.astype(int).tolist(), "chunks": [len(c) // (2 * HOP) for c in chunks],
                         "unmatched": unmatched, "where": where,
                         "windows": [records[ri][0][b].cpu().numpy().astype(int).tolist() for ri, b in windows]}
    return out


def _profile_start(w: Watch):
    import torch
    from torch.profiler import ProfilerActivity, profile

    w.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    w.prof.__enter__()
    with torch.profiler.record_function("bench.mark"):
        w.prof_marks["start_ns"] = time.perf_counter_ns()


def _profile_stop(w: Watch):
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    w.prof_marks["stop_ns"] = time.perf_counter_ns()
    w.prof.__exit__(None, None, None)


def _trace_dump(w: Watch) -> dict | None:
    """The traced slice: device kernels, the wrapper's host ranges and the
    starts of the decode steps on the profiler's clock (µs), aligned through
    the ``bench.mark`` range."""
    import torch

    if w.prof is None:
        return None
    kernels, mark = [], None
    for e in w.prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((e.name, e.time_range.start, e.time_range.end))
        elif e.name == "bench.mark" and mark is None:
            mark = e.time_range.start
    if mark is None:
        return {"error": "no bench.mark range in the trace"}
    off = w.prof_marks["start_ns"] / 1e3 - mark
    names = sorted({k[0] for k in kernels})
    pos = {n: i for i, n in enumerate(names)}
    t0, t1 = mark, w.prof_marks["stop_ns"] / 1e3 - off
    return {
        "names": names,
        "kernels": [[pos[n], s, e] for n, s, e in kernels if e > t0 and s < t1],
        "ranges": [[n, tid, s / 1e3 - off, e / 1e3 - off] for n, tid, s, e in w.ranges
                   if e / 1e3 - off > t0 and s / 1e3 - off < t1],
        "steps": [t / 1e3 - off for t in list(w.steps) if t0 <= t / 1e3 - off < t1],
        "slice": [t0, t1],
    }


class Control(BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def _reply(self, obj):
        data = json.dumps(obj).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_POST(self):
        import torch

        w = self.server.watch
        body = json.loads(self.rfile.read(int(self.headers.get("Content-Length", 0))) or b"{}")
        if self.path == "/bench/record":
            with w.lock:
                w.records.clear()
                w.sent.clear()
                w.handed.clear()
                w.recording = True
            if torch.cuda.is_available():
                torch.cuda.reset_peak_memory_stats()
            self._reply({"ok": True})
        elif self.path == "/bench/profile/start":
            w.on_profiler_thread(_profile_start)
            self._reply({"ok": True})
        elif self.path == "/bench/profile/stop":
            w.on_profiler_thread(_profile_stop)
            self._reply({"ok": True})
        elif self.path == "/bench/report":
            w.recording = False
            cuda = torch.cuda.is_available()
            trace = w.on_profiler_thread(_trace_dump) if body.get("trace") else None
            if trace is not None:
                with open(body["trace"], "w") as f:
                    json.dump(trace, f)
            self._reply({
                "engine_stats": dict(w.engine.stats) if w.engine is not None else None,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated()) if cuda else 0,
                "device": torch.cuda.get_device_name(0) if cuda else "cpu",
                "forbidden_modules": isolation.forbidden_modules(),
                "phonemes": w.phonemes,
                "served": served_codes(w, body.get("ids", [])),
                "handed": {str(k): v for k, v in w.handed.items()},
                "weight_checksum": self.server.checksum,
                "trace_error": (trace or {}).get("error"),
            })
        else:
            self.send_error(404)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--work", required=True)
    ap.add_argument("--control-port", type=int, required=True)
    ap.add_argument("--voices", type=int, default=8)
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--platform", default="cuda")
    ap.add_argument("--fault", default="")
    ap.add_argument("server_args", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    import torch

    with open(args.config) as f:
        doc = dict(json.load(f), voices=args.voices)
    watch = Watch()
    files = _write_setup(args.work, doc, args.seed)
    os.chdir(args.work)
    device = torch.device("cpu" if args.platform == "cpu" else "cuda")
    weights = make_weights(doc, args.seed, device)
    if args.fault == "weights":
        # A planted fault for the harness's tests: this backend serves one
        # weight other than the seed's.
        weights["zonos"]["embeddings.0.weight"][0, 0] += 1.0
    digest = checksum(weights)
    _install(watch, files, weights, args.trace, args.fault)
    control = ThreadingHTTPServer(("127.0.0.1", args.control_port), Control)
    control.watch = watch
    control.checksum = digest
    threading.Thread(target=control.serve_forever, daemon=True).start()
    from zonos_tpu_torch.serving import server

    server_args = [a for a in args.server_args if a != "--"]
    server.main(server_args)


if __name__ == "__main__":
    main()
