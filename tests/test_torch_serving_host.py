"""The port's host-side serving modules against JAX's copies, on the same inputs:
``serving/metrics``, ``serving/app_config``, ``serving/ui.control_specs``,
``utils/sysinfo``, ``utils/compile_cache`` and the router with stdlib fake
backends.
"""

import json
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from zonos_tpu.serving import app_config as j_app
from zonos_tpu.serving import constants as j_const
from zonos_tpu.serving import metrics as j_metrics
from zonos_tpu.serving import router as j_router
from zonos_tpu.serving import ui as j_ui
from zonos_tpu_torch.serving import app_config as t_app
from zonos_tpu_torch.serving import constants as t_const
from zonos_tpu_torch.serving import metrics as t_metrics
from zonos_tpu_torch.serving import router as t_router
from zonos_tpu_torch.serving import ui as t_ui


def test_constants_equal_jax():
    """Every constant equals JAX's but the concurrency limit: the port
    serves single requests one at a time (a deliberate difference)."""
    names = [n for n in dir(j_const) if n.isupper()]
    assert names == [n for n in dir(t_const) if n.isupper()]
    for n in names:
        if n != "CONCURRENCY_LIMIT":
            assert getattr(t_const, n) == getattr(j_const, n), n
    assert (t_const.CONCURRENCY_LIMIT, j_const.CONCURRENCY_LIMIT) == (1, 2)


def _feed(m):
    reg = m.Registry()
    for ep, st, s in (("/generate", 200, 0.3), ("/generate", 500, 12.0), ("/stream", 200, 0.07)):
        reg.counter_inc("zonos_requests_total", {"endpoint": ep, "status": str(st)}, help="requests")
        reg.histogram_observe("zonos_request_seconds", s, {"endpoint": ep}, help="latency")
    for v in (0.4, 1.7, 33.0):
        reg.histogram_observe("zonos_rtf", v, buckets=m.RTF_BUCKETS)
    reg.counter_inc("zonos_audio_seconds_total", value=2.5)
    return reg


def test_metrics_render_equal_jax():
    assert _feed(t_metrics).render() == _feed(j_metrics).render()
    for m in (t_metrics, j_metrics):
        m.REGISTRY.reset()
        m.observe_request("/health", 200, 0.01)
        m.observe_generation(1.5, 3.0, batch_size=4)
        m.observe_batch(16)
    assert t_metrics.REGISTRY.render() == j_metrics.REGISTRY.render()
    for m in (t_metrics, j_metrics):
        m.REGISTRY.reset()


def test_app_config_load_equal_jax(tmp_path):
    body = "# comment\nPATH_MODEL_TRANSFORMER = /models/t\nZONOS_BATCHING = yes\nZONOS_LOG_DIR=somewhere\nEXTRA = 7\n"
    tp, jp = tmp_path / "t.txt", tmp_path / "j.txt"
    tp.write_text(body)
    jp.write_text(body)
    assert t_app.load_config(str(tp)) == j_app.load_config(str(jp))
    assert tp.read_text() == jp.read_text()  # the same missing keys appended
    assert t_app.load_config(str(tmp_path / "none.txt")) == j_app.load_config(str(tmp_path / "none2.txt"))
    assert t_app.DEFAULT_CONFIG == j_app.DEFAULT_CONFIG
    assert t_app.setup_logging({}).name == "zonos_tpu_torch"


@pytest.mark.parametrize("names", [["espeak", "speaker", "emotion", "fmax", "pitch_std", "speaking_rate",
                                    "language_id", "vqscore_8", "ctc_loss", "dnsmos_ovrl", "speaker_noised"],
                                   ["espeak", "speaker"], []])
def test_control_specs_equal_jax(names):
    assert t_ui.control_specs(names) == j_ui.control_specs(names)


def test_build_ui_needs_gradio():
    with pytest.raises(ImportError, match="gradio"):
        t_ui.build_ui()


def test_sysinfo_matches_jax_and_reports_torch(tmp_path):
    from zonos_tpu.utils import sysinfo as j_sys
    from zonos_tpu_torch.utils import sysinfo as t_sys

    assert t_sys.get_memory_info().keys() == j_sys.get_memory_info().keys()
    assert t_sys.get_disk_info(str(tmp_path)) == j_sys.get_disk_info(str(tmp_path))
    ckpt = tmp_path / "t"
    ckpt.mkdir()
    (ckpt / "model.safetensors").write_bytes(b"")
    for config in ({}, {"PATH_MODEL_TRANSFORMER": str(ckpt)}, {"PATH_MODEL_HYBRID": str(tmp_path / "missing")}):
        assert t_sys.check_models(config) == j_sys.check_models(config)
    devices = t_sys.get_device_info()
    assert devices and all("platform" in d for d in devices)
    report = t_sys.generate_report({"PATH_MODEL_TRANSFORMER": str(ckpt), "ZONOS_QUANTIZE": True})
    assert "torch:" in report and "Model availability check:" in report
    assert "'PATH_MODEL_TRANSFORMER': '<set>'" in report  # paths in the config line are redacted, as in JAX


def test_compile_cache_on_the_cpu_builds_nothing():
    from zonos_tpu_torch.ops import _build
    from zonos_tpu_torch.utils import compile_cache

    assert compile_cache.enable("cpu") == str(_build.BUILD_DIR)


def test_router_pool_and_aggregate_equal_jax():
    for mod in (t_router, j_router):
        assert mod.BackendPool(["a"]).stats() == {"backends": [{"url": "a", "outstanding": 0, "healthy": True}]}
    picks = []
    for mod in (t_router, j_router):
        pool = mod.BackendPool(["a", "b", "c"], cooldown_s=60)
        seq = [pool.acquire() for _ in range(4)]
        pool.release(seq[0], ok=False)
        pool.release(seq[1], ok=True)
        picks.append((seq, pool.acquire(), pool.healthy_urls()))
    assert picks[0] == picks[1]
    pages = [_feed(t_metrics).render(), _feed(t_metrics).render() + "# TYPE extra counter\nextra 1\n"]
    assert t_router.aggregate_metrics(pages) == j_router.aggregate_metrics(pages)


class _Backend(BaseHTTPRequestHandler):
    """A fake zonos backend: /health, /metrics, POST /generate (echo), /lexicon, /stream (chunked)."""

    def log_message(self, *a):
        pass

    def _send(self, code, payload, ctype="application/json"):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def do_GET(self):
        if self.path == "/metrics":
            self._send(200, b"# TYPE zonos_requests_total counter\nzonos_requests_total 3\n", "text/plain")
        else:
            self._send(200, json.dumps({"status": "ok", "port": self.server.server_address[1]}).encode())

    def do_POST(self):
        body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
        if self.path == "/stream":
            self.send_response(200)
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            for part in (b"ab", b"cd"):
                self.wfile.write(f"{len(part):X}\r\n".encode() + part + b"\r\n")
            self.wfile.write(b"0\r\n\r\n")
        elif self.path == "/generate" and json.loads(body or b"{}").get("bad"):
            self._send(400, b'{"error": "bad"}')
        else:
            self._send(200, body or b"{}")


def _serve(handler):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _call(port, path, body=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=None if body is None else json.dumps(body).encode(),
                                 method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_router_over_fake_backends_equals_jax():
    backends = [_serve(_Backend) for _ in range(2)]
    urls = [f"http://127.0.0.1:{b.server_address[1]}" for b in backends]
    routers = [_serve(mod.make_handler(mod.BackendPool(urls + ["http://127.0.0.1:9"], cooldown_s=60)))
               for mod in (t_router, j_router)]
    try:
        calls = [("/metrics", None), ("/generate", {"text": "x"}), ("/generate", {"bad": True}),
                 ("/stream", {"text": "y"}), ("/lexicon", {"entries": {}})]
        for path, body in calls:
            got = [_call(r.server_address[1], path, body) for r in routers]
            assert got[0] == got[1], (path, got)
        assert _call(routers[0].server_address[1], "/stream", {})[1] == b"abcd"
        for r in routers:
            status, page = _call(r.server_address[1], "/router_stats")
            assert status == 200 and len(json.loads(page)["backends"]) == 3
    finally:
        for s in backends + routers:
            s.shutdown()
