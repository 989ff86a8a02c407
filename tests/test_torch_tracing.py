"""The port's span recorder (``zonos_tpu_torch/utils/profiling.py``) and the
spans the server, the engine and the request loops record, on the CPU.

The recorder off is one shared no-op; the ring keeps its newest spans and
counts the ones it dropped. A live ``main()`` on 127.0.0.1 (the tiny model, a
tiny DAC): a ``/stream`` request through the continuous engine records each
of its six stages once, under one request id, tiling its read → first byte
with no gap; the engine thread's ``decode.step`` spans count the steps the
engine reports; a ``/generate`` request's spans hang under its ``request``
span; ``GET /trace`` is Chrome trace-event JSON; a server that stops writes
``spans.json``.
"""

import contextlib
import glob
import json
import os
import threading
import time

import numpy as np
import pytest

from tests.test_torch_engine import tiny_dac
from tests.test_torch_server import _request, save_server_globals
from zonos_tpu_torch.serving.batcher import STREAM_STAGES
from zonos_tpu_torch.utils import profiling
from zonos_tpu_torch.utils.profiling import SpanRecorder


def test_recorder_off_is_one_shared_noop(monkeypatch):
    rec = SpanRecorder(enabled=False)
    a, b = rec.span("a"), rec.span("b", req=3, x=1)
    assert a is b
    with a:
        pass
    rec.record("c", 0, 10)
    assert rec.spans() == [] and rec.chrome_trace()["traceEvents"] == []

    saved = profiling.RECORDER.enabled
    try:
        monkeypatch.setenv("ZONOS_TRACE", "0")
        assert profiling.configure_tracing({}) is False
        assert profiling.span("x") is profiling.span("y")
        monkeypatch.delenv("ZONOS_TRACE")
        assert profiling.configure_tracing({"ZONOS_TRACE": "false"}) is False  # the configmodel.txt key
        assert profiling.configure_tracing({"ZONOS_TRACE": "1"}) is True
    finally:
        profiling.RECORDER.enabled = saved


def test_ring_keeps_the_newest_and_counts_the_dropped():
    rec = SpanRecorder(capacity=4)
    for i in range(10):
        with rec.span(f"s{i}", i=i):
            pass
    assert [s[0] for s in rec.spans()] == ["s6", "s7", "s8", "s9"]
    assert rec.dropped == 6 and rec.chrome_trace()["dropped"] == 6


def test_parents_requests_and_threads():
    rec = SpanRecorder()
    with rec.attach(7), rec.span("outer") as outer:
        with rec.span("inner", n=1):
            pass
        rec.record("later", 5, 9, k=3)
        rec.record("other_req", 5, 9, req=8)
        t = threading.Thread(target=lambda: rec.span("other").__enter__().__exit__(None, None, None))
        t.start()
        t.join(timeout=10)
    rec.record("after", 1, 2)
    by = {s[0]: s for s in rec.spans()}
    name, sid, parent, req, tid, start, end, args = by["inner"]
    assert parent == outer.id and req == 7 and args == {"n": 1} and end >= start
    assert by["outer"][2] is None and by["outer"][3] == 7
    assert by["other"][2] is None and by["other"][3] is None and by["other"][4] != tid  # another thread
    assert by["later"][2:4] == (outer.id, 7) and by["later"][5:] == (5, 9, {"k": 3})
    assert by["other_req"][2:4] == (outer.id, 8)
    assert by["after"][2:4] == (None, None)
    assert len({s[1] for s in rec.spans()}) == len(rec.spans())  # ids are unique
    ev = next(e for e in rec.chrome_trace()["traceEvents"] if e["name"] == "inner")
    assert ev["ph"] == "X" and ev["dur"] == pytest.approx((end - start) / 1e3) and ev["ts"] == start / 1e3
    assert ev["args"] == {"n": 1, "id": sid, "parent": outer.id, "req": 7}


def test_traced_records_each_call():
    calls = []

    @profiling.traced("test.traced")
    def work(x, y=1):
        calls.append(profiling.RECORDER._local.stack[-1])
        return x + y

    t0 = time.perf_counter_ns()
    assert work(2, y=3) == 5 and work.__name__ == "work"
    spans = [s for s in profiling.RECORDER.spans() if s[0] == "test.traced" and s[5] >= t0]
    assert [s[1] for s in spans] == calls


@contextlib.contextmanager
def serving(workdir, *args):
    """``server.main()`` in a thread on 127.0.0.1 (port 0) in ``workdir``:
    yields (server module, port); shuts it down and puts back what it set."""
    from zonos_tpu_torch.serving import model_manager as tmm
    from zonos_tpu_torch.serving import server as tsrv

    restore = save_server_globals()
    saved_env = {k: os.environ.get(k) for k in ("ZONOS_PLATFORM", "ZONOS_TINY_MODEL")}
    saved_model = (tmm._CURRENT_MODEL, tmm._CURRENT_NAME)
    saved_enabled = profiling.RECORDER.enabled
    cwd = os.getcwd()
    os.chdir(workdir)
    os.environ.update(ZONOS_PLATFORM="cpu", ZONOS_TINY_MODEL="1")
    tsrv._SERVER = tmm._CURRENT_MODEL = None
    thread = threading.Thread(target=tsrv.main, args=(["--server", "127.0.0.1", "--port", "0", *args],),
                              daemon=True)
    thread.start()
    try:
        for _ in range(1200):
            if tsrv._SERVER is not None:
                break
            time.sleep(0.05)
        yield tsrv, tsrv._SERVER.server_address[1]
    finally:
        if tsrv._SERVER is not None:
            tsrv._SERVER.shutdown()
        thread.join(timeout=60)
        assert not thread.is_alive()
        restore()
        profiling.RECORDER.enabled = saved_enabled
        os.chdir(cwd)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        tmm._CURRENT_MODEL, tmm._CURRENT_NAME = saved_model


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    from zonos_tpu_torch.serving import model_manager as tmm

    with serving(tmp_path_factory.mktemp("tracing"), "--no-preload") as (tsrv, port):
        model = tmm.load_model_if_needed(config=tsrv._APP_CONFIG)
        model._autoencoder = tiny_dac()
        yield tsrv, port


@pytest.fixture
def engine(server, monkeypatch):
    """The server with ``ZONOS_BATCHING=1``: requests go through a fresh continuous engine."""
    tsrv, port = server
    monkeypatch.setenv("ZONOS_BATCHING", "1")
    monkeypatch.setenv("ZONOS_MAX_BATCH", "2")
    monkeypatch.setenv("ZONOS_ENGINE_MAX_NEW", "200")
    try:
        yield tsrv, port
    finally:
        if tsrv._BATCHER is not None:
            tsrv._BATCHER.close()
        tsrv._BATCHER = tsrv._BATCHER_MODEL = None


def _stream(port, text, seed):
    code, _headers, data = _request(port, "/stream", {"text": text, "seed": seed, "randomize_seed": False})
    assert code == 200 and len(data) > 0


def _spans_since(t0, name="request", timeout=10.0):
    """The spans that began at or after ``t0`` (ns), once a span ``name`` is
    among them: the handler closes its ``request`` span just after the client
    has read the last byte."""
    deadline = time.monotonic() + timeout
    while True:
        spans = [s for s in profiling.RECORDER.spans() if s[5] >= t0]
        if any(s[0] == name for s in spans) or time.monotonic() > deadline:
            return spans
        time.sleep(0.01)


def test_stream_stages_tile_read_to_first_byte(engine):
    _tsrv, port = engine
    t0 = time.perf_counter_ns()
    _stream(port, "a traced line", 4)
    spans = _spans_since(t0)
    stages = [s for s in spans if s[0] in {n for n, _, _ in STREAM_STAGES}]
    assert [s[0] for s in sorted(stages, key=lambda s: s[5])] == [n for n, _, _ in STREAM_STAGES]
    (req,) = {s[3] for s in stages}
    (request,) = [s for s in spans if s[0] == "request" and s[3] == req]
    assert {s[2] for s in stages} == {request[1]}
    ordered = sorted(stages, key=lambda s: s[5])
    for a, b in zip(ordered, ordered[1:]):
        assert 0 <= b[5] - a[6] <= 1_000_000  # no gap over 1 ms, no overlap
    assert ordered[0][5] <= request[5] + 1_000_000 and ordered[-1][6] <= request[6]
    # The children recorded on other threads carry the request's id and lie
    # inside their stage.
    by = {s[0]: s for s in stages}
    (run,) = [s for s in spans if s[0] == "prep.run" and s[3] == req]
    assert by["prep"][5] <= run[5] and run[6] <= by["prep"][6]
    (readback,) = [s for s in spans if s[0] == "ship.readback" and s[3] == req]
    assert by["ship"][5] <= readback[5] and readback[6] <= by["ship"][6]


def test_engine_decode_steps_count_the_engine_steps(engine):
    tsrv, port = engine
    t0 = time.perf_counter_ns()
    _stream(port, "count the steps", 5)
    _stream(port, "and a second line", 6)
    eng = tsrv._BATCHER
    eng.close()
    spans = _spans_since(t0)
    worker = eng._thread.ident
    steps = [s for s in spans if s[0] == "decode.step" and s[4] == worker]
    assert len(steps) == eng.stats["steps"] > 0
    dispatch = {s[1]: s for s in spans if s[0] == "engine.dispatch"}
    assert {s[2] for s in steps} <= set(dispatch)
    assert all(0 <= d[7]["active"] <= eng.slots and eng.prefill_len < d[7]["rung"] <= eng.cache_len
               for d in dispatch.values())
    names = {s[0] for s in spans if s[4] == worker}
    assert {"engine.mutate", "engine.absorb", "engine.harvest", "engine.status_wait", "engine.plan",
            "engine.retire"} <= names


def test_generate_request_span_tree(server, monkeypatch):
    from zonos_tpu_torch.serving import pipeline

    _tsrv, port = server
    monkeypatch.setattr(pipeline, "process_speaker_audio",
                        lambda *a, **k: np.zeros((1, 1, 128), np.float32))
    t0 = time.perf_counter_ns()
    code, _h, _data = _request(port, "/generate", {"text": "a whole line", "seed": 2, "randomize_seed": False,
                                                   "speaker_audio": "voice.wav"})
    assert code == 200
    spans = _spans_since(t0)
    (request,) = [s for s in spans if s[0] == "request"]
    assert request[7] == {"endpoint": "/generate"}
    children = {s[0] for s in spans if s[2] == request[1]}
    assert {"pipeline.speaker", "pipeline.conditioning", "decode.prefill", "decode.step", "codec.decode",
            "pipeline.write_wav", "front.write"} <= children
    assert all(s[3] == request[3] for s in spans if s[4] == request[4])  # one request id on its thread
    by_id = {s[1]: s for s in spans}
    syncs = [s for s in spans if s[0] == "decode.sync"]
    assert syncs and all(by_id[s[2]][0] in ("decode.step", "request") for s in syncs)


def test_trace_route_is_chrome_trace_json(server):
    _tsrv, port = server
    with profiling.span("test.route", n=1):
        pass
    code, headers, data = _request(port, "/trace")
    assert code == 200 and headers["Content-Type"] == "application/json"
    doc = json.loads(data)
    assert doc["clock"] == "perf_counter_ns" and isinstance(doc["dropped"], int)
    ev = next(e for e in doc["traceEvents"] if e["name"] == "test.route")
    assert ev["ph"] == "X" and ev["dur"] >= 0 and isinstance(ev["ts"], float)
    assert {"id", "parent", "req", "n"} == set(ev["args"])


def test_shutdown_writes_spans_json(tmp_path):
    with serving(tmp_path, "--no-preload"):
        with profiling.span("test.before_stop"):
            pass
    (path,) = glob.glob(str(tmp_path / "output_temp" / "*" / "spans.json"))
    with open(path) as f:
        doc = json.load(f)
    assert any(e["name"] == "test.before_stop" for e in doc["traceEvents"])
