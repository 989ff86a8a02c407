"""The port's HTTP server (``serving/server.py``), live on 127.0.0.1.

``main()`` runs in a thread with ``ZONOS_PLATFORM=cpu ZONOS_TINY_MODEL=1``
(tiny random model, a tiny DAC swapped in), beside JAX's handler on another
port. Every GET route, ping and the client errors give JAX's status codes,
content types, headers and JSON keys for the same bodies; ``/generate``
equals ``pipeline.tts`` on the same inputs; ``/stream``'s chunks concatenate
to ``handle_stream``'s, and a stream reports its decode steps; two
concurrent requests each equal their solo run;
``ZONOS_BATCHING=1`` serves through the engine and, with
``ZONOS_CONTINUOUS=0``, through the dynamic batcher.
"""

import io
import json
import os
import threading
import time
import urllib.error
import urllib.request
import wave
from http.server import ThreadingHTTPServer

import pytest

from tests.test_torch_engine import tiny_dac


def _request(port, path, body=None, method=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method=method or ("GET" if body is None else "POST"))
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def save_server_globals():
    """The process-global state that ``server.main()`` and the routes write:
    the phoneme bucket (``main`` sets the server's, 32), the app config and
    the listening server, the port's logger that ``setup_logging`` configures
    once, ``HF_HOME`` (set from the app config), and the lexicon entries of
    both packages (POST /lexicon). Returns a function that puts all of it
    back, so that no later test in the process sees a server's settings."""
    import logging

    from zonos_tpu.conditioning import lexicon as jlex
    from zonos_tpu_torch.conditioning import lexicon as tlex
    from zonos_tpu_torch.conditioning import text as ttext
    from zonos_tpu_torch.serving import app_config as tcfg
    from zonos_tpu_torch.serving import server as tsrv

    logger = logging.getLogger("zonos_tpu_torch")
    saved = (ttext.PAD_BUCKET, tsrv._APP_CONFIG, tsrv._SERVER, tcfg._LOGGING_DONE, list(logger.handlers),
             logger.level, os.environ.get("HF_HOME"), {lex: lex.entries() for lex in (jlex, tlex)})

    def restore():
        (ttext.PAD_BUCKET, tsrv._APP_CONFIG, tsrv._SERVER, tcfg._LOGGING_DONE, handlers, level, hf_home,
         lexicons) = saved
        for h in logger.handlers[:]:
            if h not in handlers:
                logger.removeHandler(h)
        logger.setLevel(level)
        if hf_home is None:
            os.environ.pop("HF_HOME", None)
        else:
            os.environ["HF_HOME"] = hf_home
        for lex, entries in lexicons.items():
            lex.remove(None)
            for word, by_lang in entries.items():
                for lang, ipa in by_lang.items():
                    lex.set_entries({word: ipa}, lang or None)

    return restore


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    from zonos_tpu.serving import model_manager as jmm
    from zonos_tpu.serving import server as jsrv
    from zonos_tpu_torch.serving import model_manager as tmm
    from zonos_tpu_torch.serving import server as tsrv

    saved_env = {k: os.environ.get(k) for k in ("ZONOS_PLATFORM", "ZONOS_TINY_MODEL")}
    restore_globals = save_server_globals()
    saved_state = (jmm._CURRENT_MODEL, jmm._CURRENT_NAME, tmm._CURRENT_MODEL, tmm._CURRENT_NAME)
    cwd = os.getcwd()
    os.chdir(tmp_path_factory.mktemp("torch_server"))
    os.environ.update(ZONOS_PLATFORM="cpu", ZONOS_TINY_MODEL="1")
    tmm._CURRENT_MODEL = jmm._CURRENT_MODEL = None
    thread = threading.Thread(target=tsrv.main, args=(["--server", "127.0.0.1", "--port", "0", "--no-preload"],),
                              daemon=True)
    thread.start()
    for _ in range(600):
        if tsrv._SERVER is not None:
            break
        time.sleep(0.05)
    model = tmm.load_model_if_needed(config=tsrv._APP_CONFIG)
    model._autoencoder = tiny_dac()
    jserver = ThreadingHTTPServer(("127.0.0.1", 0), jsrv.Handler)
    threading.Thread(target=jserver.serve_forever, daemon=True).start()
    yield tsrv, model, tsrv._SERVER.server_address[1], jserver.server_address[1]
    tsrv._SERVER.shutdown()
    jserver.shutdown()
    thread.join(timeout=30)
    restore_globals()
    os.chdir(cwd)
    for k, v in saved_env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    jmm._CURRENT_MODEL, jmm._CURRENT_NAME, tmm._CURRENT_MODEL, tmm._CURRENT_NAME = saved_state


def _wav_frames(data: bytes):
    with wave.open(io.BytesIO(data)) as w:
        return w.getframerate(), w.getnframes(), w.getsampwidth()


@pytest.mark.parametrize("path", ["/health", "/models", "/languages", "/conditioners", "/ui_spec", "/lexicon",
                                  "/speakers", "/metrics", "/", "/no-such-route"])
def test_get_routes_match_jax(servers, path):
    _tsrv, _model, port, jport = servers
    code, headers, body = _request(port, path)
    jcode, jheaders, jbody = _request(jport, path)
    assert code == jcode
    assert headers["Content-Type"] == jheaders["Content-Type"]
    if headers["Content-Type"] == "application/json":
        got, ref = json.loads(body), json.loads(jbody)
        assert got.keys() == ref.keys()
        if path in ("/health", "/models", "/conditioners", "/ui_spec", "/lexicon", "/speakers", "/no-such-route"):
            assert got == ref
        if path == "/languages":
            assert got["languages"] == ref["languages"]
    elif path == "/":
        assert b"/ui_spec" in body and b"/generate" in body


def test_ping_and_client_errors_match_jax(servers):
    _tsrv, _model, port, jport = servers
    cases = [("/generate", {"text": "ping"}), ("/generate", {"text": "hi", "speaker": "nobody"}),
             ("/generate", {"text": "hi", "speaker": "../etc"}),
             ("/v1/audio/speech", {"input": "hi", "response_format": "mp3"}),
             ("/speakers", {"name": "x"}), ("/speakers", {"name": "bad name!", "wav_base64": "AAAA"}),
             ("/lexicon", {"entries": {"zonos": "zoʊnɒs"}}), ("/lexicon", {"clear": True}), ("/nowhere", {})]
    for path, body in cases:
        got, ref = _request(port, path, body), _request(jport, path, body)
        assert got[0] == ref[0], (path, body)
        for h in ("Content-Type", "X-Zonos-Meta"):
            assert got[1].get(h) == ref[1].get(h), (path, body, h)
        if got[1]["Content-Type"] == "application/json":
            assert json.loads(got[2]).keys() == json.loads(ref[2]).keys()
        else:
            assert got[2] == ref[2]  # ping: the same 100 ms of silence


def test_generate_equals_pipeline_tts(servers):
    tsrv, model, port, _jport = servers
    from zonos_tpu_torch.serving.pipeline import tts

    body = {"text": "hi there", "seed": 3, "randomize_seed": False}
    code, headers, data = _request(port, "/generate", body)
    assert code == 200 and headers["Content-Type"] == "audio/wav"
    meta = json.loads(headers["X-Zonos-Meta"])
    assert set(meta) == {"path", "rtf", "sample_rate"}  # JAX's handle_generate keys
    sr, frames, width = _wav_frames(data)
    assert (sr, width) == (44100, 2) and frames > 0
    _path, wav, sr2, _rtf = tts(model, "hi there", seed=3, randomize_seed=False)
    assert data == tsrv._wav_bytes(wav, sr2)
    assert _request(port, "/generate", body)[2] == data  # a fixed seed gives the same bytes


def test_stream_chunks_concatenate_to_handle_stream(servers):
    tsrv, _model, port, _jport = servers
    body = {"text": "stream me", "seed": 5, "randomize_seed": False}
    code, headers, data = _request(port, "/stream", body)
    assert code == 200
    assert (headers["Transfer-Encoding"], headers["X-Sample-Rate"], headers["X-PCM-Format"]) == (
        "chunked", "44100", "s16le-mono")
    assert data == b"".join(c for c, _ in tsrv.handle_stream(dict(body)))
    assert len(data) > 0 and len(data) % 2 == 0


def test_stream_reports_its_decode_steps(servers):
    """``Zonos.stream(stats=...)`` gives the decode steps it ran (phase 10
    checks the /stream launch counts against them): those of
    ``generate_audio`` on the same request."""
    import numpy as np

    from zonos_tpu_torch.conditioning.cond_dict import make_cond_dict

    _tsrv, model, _port, _jport = servers
    cond = model.prepare_conditioning(make_cond_dict(text="count my steps", speaker=np.zeros((1, 1, 128), np.float32)))
    streamed, whole = {}, {}
    chunks = list(model.stream(cond, max_new_tokens=24, seed=3, stats=streamed))
    model.generate_audio(cond, max_new_tokens=24, seed=3, stats=whole)
    assert len(chunks) >= 1 and streamed["decode_steps"] == whole["decode_steps"] > 0


def test_two_concurrent_requests_equal_their_solo_runs(servers):
    _tsrv, _model, port, _jport = servers
    bodies = [{"text": "first voice", "seed": 11, "randomize_seed": False},
              {"text": "the second one", "seed": 12, "randomize_seed": False}]
    solo = [_request(port, "/generate", b)[2] for b in bodies]
    got = {}
    threads = [threading.Thread(target=lambda i: got.__setitem__(i, _request(port, "/generate", bodies[i])), args=(i,))
               for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert [got[i][0] for i in range(2)] == [200, 200]
    assert [got[i][2] for i in range(2)] == solo


@pytest.mark.parametrize("continuous", ["1", "0"])
def test_batching_paths(servers, monkeypatch, continuous):
    tsrv, _model, port, _jport = servers
    monkeypatch.setenv("ZONOS_BATCHING", "1")
    monkeypatch.setenv("ZONOS_CONTINUOUS", continuous)
    try:
        got = {}
        bodies = [{"text": f"batched request {i}", "seed": 20 + i, "randomize_seed": False} for i in range(2)]
        threads = [threading.Thread(target=lambda i: got.__setitem__(i, _request(port, "/generate", bodies[i])),
                                    args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        for i in range(2):
            code, headers, data = got[i]
            assert code == 200
            meta = json.loads(headers["X-Zonos-Meta"])
            assert meta["batched"] is True and meta["sample_rate"] == 44100
            assert _wav_frames(data)[1] > 0
        kind = "ContinuousEngine" if continuous == "1" else "DynamicBatcher"
        assert type(tsrv._BATCHER).__name__ == kind and tsrv._BATCHER.stats["requests"] == 2
        code, headers, data = _request(port, "/stream", bodies[0])
        assert code == 200 and len(data) > 0
    finally:
        if tsrv._BATCHER is not None:
            tsrv._BATCHER.close()
        tsrv._BATCHER = tsrv._BATCHER_MODEL = None


def test_router_relays_generate_and_longform_bit_equal(servers, monkeypatch):
    """``serving/router.py`` in front of the live server (one backend), as
    docs/DEPLOYMENT.md puts it before each fleet: a /generate and a
    long-form /generate (chunks of at most 15 characters) come back
    through the router with the bytes the server answers direct, and each
    long-form request names a wav path of its own. (Two chunks here;
    test_torch_serving.py holds three-chunk long-form PCM to JAX's.)"""
    from zonos_tpu_torch.serving import longform, router

    _tsrv, _model, port, _jport = servers
    monkeypatch.setattr(longform, "MAX_CHUNK_CHARS", 15)
    front = ThreadingHTTPServer(("127.0.0.1", 0), router.make_handler(router.BackendPool([f"http://127.0.0.1:{port}"])))
    threading.Thread(target=front.serve_forever, daemon=True).start()
    try:
        rport = front.server_address[1]
        short = {"text": "via the router", "seed": 7, "randomize_seed": False}
        long_ = {"text": "Good evening. Stay awhile.", "seed": 8, "randomize_seed": False}
        assert len(longform.chunk_text(long_["text"])) == 2
        paths = []
        for body in (short, long_):
            code, headers, data = _request(rport, "/generate", body)
            dcode, dheaders, direct = _request(port, "/generate", body)
            assert code == dcode == 200 and headers["Content-Type"] == "audio/wav"
            assert data == direct and _wav_frames(data)[1] > 0
            paths += [json.loads(h["X-Zonos-Meta"])["path"] for h in (headers, dheaders)]
        assert len(set(paths)) == 4
        stats = json.loads(_request(rport, "/router_stats")[2])
        assert stats["backends"] == [{"url": f"http://127.0.0.1:{port}", "outstanding": 0, "healthy": True}]
    finally:
        front.shutdown()


def test_router_passes_each_stream_chunk_on_as_it_arrives():
    """/stream through ``serving/router.py``: a backend's first chunk reaches
    the client while the backend still holds the rest, so time to the first
    audio through the router is one hop more than direct, not the wait for
    32 KB of PCM (the engine's first chunk is 16 KB). The backend here is a
    stub that sends 16 bytes, then waits for the test's event."""
    import http.client
    from http.server import BaseHTTPRequestHandler

    from zonos_tpu_torch.serving import router

    release = threading.Event()

    class Backend(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def do_POST(self):
            self.rfile.read(int(self.headers.get("Content-Length", 0)))
            self.send_response(200)
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            for part in (b"\x01\x00" * 8, None, b"\x02\x00" * 8):
                if part is None:
                    release.wait(30)
                    continue
                self.wfile.write(f"{len(part):X}\r\n".encode() + part + b"\r\n")
                self.wfile.flush()
            self.wfile.write(b"0\r\n\r\n")

    backend = ThreadingHTTPServer(("127.0.0.1", 0), Backend)
    pool = router.BackendPool([f"http://127.0.0.1:{backend.server_address[1]}"])
    front = ThreadingHTTPServer(("127.0.0.1", 0), router.make_handler(pool))
    for srv in (backend, front):
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    conn = http.client.HTTPConnection("127.0.0.1", front.server_address[1], timeout=10)
    try:
        conn.request("POST", "/stream", b"{}", {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        first = resp.read(16)  # the backend holds its second chunk until release
        assert first == b"\x01\x00" * 8
    finally:
        release.set()
    try:
        assert resp.read() == b"\x02\x00" * 8
    finally:
        conn.close()
        front.shutdown()
        backend.shutdown()
