"""``zonos_tpu_torch.tools.bench`` against ``bench.py``, on the CPU at the
tiny configurations.

The recipe (constants, metric, the keys of ``extra``, the tiny DAC, the
conditioning draws and their order) is read from ``bench.py`` itself: its
module constants by importing it (it imports only the standard library and
numpy at module level), the rest from its syntax tree. The sequential and
pipelined legs run a tiny transformer built in JAX and bridged, at greedy
and f32, against ``zonos_tpu``'s ``generate`` and ``generate_audio``.
"""

import ast
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_dac_encoder import DAC_KW, _np_params
from tests.test_torch_tools_demo import one_thread  # noqa: F401  autouse: one torch thread per test
from zonos_tpu.codec import dac as JDAC
from zonos_tpu.config import tiny_transformer_config as j_tiny
from zonos_tpu.models.zonos import Zonos as JZonos
from zonos_tpu.ops.sampling import SamplingParams as JSamplingParams
from zonos_tpu.runtime import generate as JG
from zonos_tpu.runtime import streaming as JS
from zonos_tpu_torch.bridge import dac_params_from_jax, params_from_jax
from zonos_tpu_torch.codec.dac import DACAutoencoder
from zonos_tpu_torch.conditioning import text as T_text
from zonos_tpu_torch.config import DACConfig, tiny_hybrid_config, tiny_transformer_config
from zonos_tpu_torch.models.zonos import Zonos
from zonos_tpu_torch.ops.sampling import SamplingParams
from zonos_tpu_torch.runtime.streaming import LOCAL_CHUNK_FRAMES
from zonos_tpu_torch.tools import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_PY = os.path.join(REPO, "bench.py")
EXTRA_PORT_KEYS = ["card", "power_limit_w"]


def _jax_bench():
    spec = importlib.util.spec_from_file_location("jax_bench", BENCH_PY)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def bench_main():
    """The body of ``bench.py``'s ``main``: its syntax tree, and each simple
    assignment ``name = value`` in it by name (an ``a if tiny else b`` as
    the pair (a, b))."""
    with open(BENCH_PY, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    assigns = {}
    for node in ast.walk(main):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and isinstance(node.targets[0], ast.Name):
            assigns[node.targets[0].id] = node
    return main, assigns


def _calls(main, name):
    """Calls in ``main`` of a function or method called ``name``, in source order."""
    found = [n for n in ast.walk(main) if isinstance(n, ast.Call)
             and (getattr(n.func, "id", None) == name or getattr(n.func, "attr", None) == name)]
    return sorted(found, key=lambda n: (n.lineno, n.col_offset))


def _tiny_or_full(node):
    assert isinstance(node, ast.IfExp) and ast.unparse(node.test) == "tiny"
    return node.body, node.orelse


def test_recipe_matches_bench_py(bench_main):
    main, assigns = bench_main
    jb = _jax_bench()
    assert (bench.BASELINE_RTF, bench.SECONDS, bench.FRAMES_PER_SEC) == (jb.BASELINE_RTF, jb.SECONDS,
                                                                          jb.FRAMES_PER_SEC)
    lit = {name: ast.literal_eval(assigns[name].value) for name in ("lc", "n_runs", "n_h", "B")}
    assert (bench.LC, bench.N_RUNS, bench.HYBRID_RUNS, bench.BATCH) == (lit["lc"], lit["n_runs"], lit["n_h"],
                                                                        lit["B"])
    tiny_frames, full_frames = _tiny_or_full(assigns["max_new"].value)
    assert ast.literal_eval(tiny_frames) == bench.TINY_FRAMES
    assert ast.unparse(full_frames) == "int(SECONDS * FRAMES_PER_SEC)"
    tiny_n, full_n = _tiny_or_full(assigns["n_sus"].value)
    assert (ast.literal_eval(tiny_n), ast.literal_eval(full_n)) == (bench.TINY_ENGINE_REQUESTS, bench.ENGINE_REQUESTS)
    tiny_e, full_e = _tiny_or_full(assigns["max_new_e"].value)
    assert ast.literal_eval(tiny_e) == bench.TINY_FRAMES
    assert ast.unparse(full_e) == f"int({bench.ENGINE_SECONDS} * FRAMES_PER_SEC)"
    budget = assigns["budget_s"].value.args[0]
    assert ast.literal_eval(budget.args[1]) == bench.BUDGET_S and budget.args[0].value == "ZONOS_BENCH_BUDGET_S"
    # the legs' thresholds on the time left, in bench.py's order of the legs
    thresholds = [ast.literal_eval(n.comparators[0]) for n in ast.walk(main)
                  if isinstance(n, ast.Compare) and ast.unparse(n.left) == "left()"]
    assert sorted(thresholds) == thresholds == [bench.LEFT_S[leg] for leg in ("ttfa", "batch8", "engine", "hybrid")]
    # the engine: slots, window, the server's phoneme bucket, the three loads
    (eng,) = _calls(main, "ContinuousEngine")
    assert {k.arg: ast.literal_eval(k.value) for k in eng.keywords} == {"slots": bench.ENGINE_SLOTS,
                                                                       "window_ms": bench.ENGINE_WINDOW_MS}
    bucket = next(n for n in ast.walk(main) if isinstance(n, ast.Assign)
                  and ast.unparse(n.targets[0]) == "_text.PAD_BUCKET")
    assert ast.literal_eval(bucket.value) == bench.ENGINE_PAD_BUCKET
    burst, warm, timed = [c for c in _calls(main, "run_load") if len(c.args) == 3]
    assert [ast.literal_eval(a) for a in burst.args[:2]] == [bench.ENGINE_WARM_BURST, 0.0]
    tiny_w, full_w = _tiny_or_full(warm.args[0])
    assert [ast.literal_eval(tiny_w), ast.literal_eval(full_w), ast.literal_eval(warm.args[1])] == [
        bench.TINY_ENGINE_WARM_REQUESTS, bench.ENGINE_WARM_REQUESTS, bench.ENGINE_WARM_INTERVAL_S]
    assert ast.unparse(timed.args[0]) == "n_sus" and ast.literal_eval(timed.args[1]) == bench.ENGINE_INTERVAL_S
    (stream,) = _calls(main, "generate_stream")
    kw = {k.arg: k.value for k in stream.keywords}
    assert (ast.literal_eval(kw["first_chunk_frames"]), ast.literal_eval(kw["chunk_frames"])) == (
        bench.FIRST_CHUNK_FRAMES, bench.CHUNK_FRAMES)
    ttfa_runs = next(n for n in ast.walk(main) if isinstance(n, ast.Call) and ast.unparse(n.func) == "sorted")
    assert ast.unparse(ttfa_runs.args[0].generators[0].iter) == f"range({bench.TTFA_RUNS})"
    # the JSON line: the metric, its unit and the keys of extra
    result = assigns["result"].value
    fields = {ast.literal_eval(k): v for k, v in zip(result.keys, result.values)}
    assert list(fields) == ["metric", "value", "unit", "vs_baseline", "extra"]
    assert (ast.literal_eval(fields["metric"]), ast.literal_eval(fields["unit"])) == (bench.METRIC, "x_realtime")
    extra = [ast.literal_eval(k) for k in assigns["extra"].value.keys]
    assert len(extra) == 6 and bench.EXTRA_KEYS == tuple(extra)
    # the tiny DAC and its frame bucket
    (dac_cfg,) = _calls(main, "DACConfig")
    assert {k.arg: ast.literal_eval(k.value) for k in dac_cfg.keywords} == bench.TINY_DAC
    (ae,) = [c for c in _calls(main, "DACAutoencoder") if c.keywords and c.keywords[0].arg == "params"]
    assert ast.literal_eval(next(k.value for k in ae.keywords if k.arg == "frame_bucket")) == bench.TINY_FRAME_BUCKET


def test_conditioning_draws_follow_bench_py(bench_main):
    """cond, cond8 and hcond come from one default_rng(0) in bench.py's order,
    with its shapes and scale: the port's draws equal a replay of bench.py's."""
    main, assigns = bench_main
    draws = sorted((assigns[name] for name in ("cond", "cond8", "hcond")), key=lambda n: n.lineno)
    assert [n.targets[0].id for n in draws] == ["cond", "cond8", "hcond"]
    assert ast.unparse(assigns["rng"].value) == "np.random.default_rng(0)"
    d, hd = tiny_transformer_config().backbone.d_model, tiny_hybrid_config().backbone.d_model
    hcfg = type("H", (), {"backbone": type("B", (), {"d_model": hd})})
    env = {"lc": bench.LC, "d": d, "B": bench.BATCH, "hcfg": hcfg}
    rng = np.random.default_rng(0)
    want = []
    for node in draws:
        value = node.value  # rng.normal(size=...).astype(np.float32) * scale
        assert isinstance(value, ast.BinOp) and isinstance(value.op, ast.Mult)
        size = eval(compile(ast.Expression(value.left.func.value.keywords[0].value), BENCH_PY, "eval"), env)
        want.append(rng.normal(size=size).astype(np.float32) * ast.literal_eval(value.right))
    rng = np.random.default_rng(0)
    got = [bench.draw_cond(rng, d), bench.draw_cond(rng, d, bench.BATCH), bench.draw_cond(rng, hd)]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def bridged():
    """A tiny transformer and the tiny DAC built in JAX (f32), and the port's
    copies through ``zonos_tpu_torch.bridge``."""
    jm = JZonos.from_config(j_tiny(), seed=0, dtype=jnp.float32)
    jcfg = JDAC.DACConfig(**DAC_KW)
    np_dac = _np_params(jcfg, seed=5)
    jae = JDAC.DACAutoencoder(params=jax.tree.map(jnp.asarray, np_dac), cfg=jcfg, dtype=jnp.float32,
                              frame_bucket=bench.TINY_FRAME_BUCKET)
    port = Zonos(tiny_transformer_config(), params_from_jax(jax.tree.map(np.asarray, jm.params)),
                 dtype=torch.float32, device="cpu")
    tae = DACAutoencoder(params=dac_params_from_jax(np_dac), cfg=DACConfig(**DAC_KW), dtype=torch.float32,
                         frame_bucket=bench.TINY_FRAME_BUCKET, device="cpu")
    cond = bench.draw_cond(np.random.default_rng(0), port.config.backbone.d_model)
    return jm, jae, port, tae, cond


GREEDY = dict(frames=bench.TINY_FRAMES, runs=1, sampling=SamplingParams(temperature=0.0), kv_int8=True)


def _jax_kw():
    return dict(max_new_tokens=bench.TINY_FRAMES, cfg_scale=2.0, sampling_params=JSamplingParams(temperature=0.0),
                seed=2, dtype=jnp.float32, forbid_eos=True, kv_int8=True)


def test_sequential_leg_codes_equal_jax_generate(bridged):
    jm, jae, port, tae, cond = bridged
    out = bench.sequential(port, tae, cond, **GREEDY)
    ref = JG.generate(jm.params, jm.config, cond, **_jax_kw())
    assert out["codes"].shape == ref.shape == (1, 9, bench.TINY_FRAMES)
    np.testing.assert_array_equal(out["codes"], ref)
    assert out["decode_steps"] == [out["decode_steps"][0]] * 2  # the warm-up and the timed run
    assert out["rtf"] > 0 and out["decode_ms_per_frame"] > 0
    # the decode of those codes: JAX's DAC on the same weights, as tests/test_torch_dac_encoder.py holds it
    np.testing.assert_allclose(out["wav"], np.asarray(jae.decode(ref)), rtol=0, atol=1e-5)


def test_pipelined_leg_pcm_matches_jax_generate_audio(bridged):
    """int16 PCM, as the recipe serves it. Tolerance: tests/test_torch_streaming.py
    holds the two packages' float PCM to 1e-4; after the x32767 and the
    truncation to int16 that is 1e-4 + 1 LSB of full scale."""
    jm, jae, port, tae, cond = bridged
    out = bench.pipelined(port, tae, cond, pcm_int16=True, **GREEDY)
    ref, ref_len = JS.generate_audio(jm.params, jm.config, cond, jae, chunk_frames=LOCAL_CHUNK_FRAMES,
                                     pcm_int16=True, **_jax_kw())
    np.testing.assert_array_equal(out["lengths"], ref_len)
    assert out["wav"].dtype == np.int16 and out["wav"].shape == ref.shape
    assert np.abs(out["wav"]).max() > 100  # audible PCM
    np.testing.assert_allclose(out["wav"] / 32767.0, np.asarray(ref) / 32767.0, rtol=0, atol=1e-4 + 1 / 32767)
    assert out["rtf"] > 0


def _json_line(out: str) -> dict:
    lines = [line for line in out.splitlines() if line.startswith("{")]
    assert len(lines) == 1, out
    return json.loads(lines[0])


def test_tiny_preset_runs_every_leg_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setenv("ZONOS_BENCH_PRESET", "tiny")
    monkeypatch.delenv("ZONOS_BENCH_DENSE", raising=False)
    monkeypatch.setattr(T_text, "PAD_BUCKET", 5)  # a value the engine leg must put back
    assert bench.main(["--device", "cpu"]) == 0
    result = _json_line(capsys.readouterr().out)
    assert list(result) == ["metric", "value", "unit", "vs_baseline", "extra"]
    assert list(result["extra"]) == [*bench.EXTRA_KEYS, *EXTRA_PORT_KEYS]
    assert result["metric"] == bench.METRIC and result["unit"] == "x_realtime"
    assert abs(result["vs_baseline"] - result["value"] / bench.BASELINE_RTF) <= 1e-3  # both rounded to 1e-3
    for key in ("value", "vs_baseline", *bench.EXTRA_KEYS):
        value = result[key] if key in result else result["extra"][key]
        assert isinstance(value, float) and np.isfinite(value) and value > 0, (key, value)
    assert (result["extra"]["card"], result["extra"]["power_limit_w"]) == ("cpu", None)
    assert T_text.PAD_BUCKET == 5


def test_a_leg_that_raises_fails_the_run(monkeypatch, capsys):
    """bench.py prints the sequential RTF as ``value`` when the pipelined leg
    raises; the port's run fails instead."""
    def broken(*args, **kwargs):
        raise RuntimeError("leg broke")

    monkeypatch.setenv("ZONOS_BENCH_PRESET", "tiny")
    monkeypatch.setattr(bench, "pipelined", broken)
    assert bench.main(["--device", "cpu"]) == 1
    out, err = capsys.readouterr()
    assert "{" not in out and "RuntimeError: leg broke" in err and "Traceback" in err


def test_an_engine_request_that_raises_fails_its_leg(monkeypatch):
    """A request's error in a submitting thread reaches the leg, and the
    phoneme bucket and the engine are put back all the same."""
    from zonos_tpu_torch.serving import continuous

    def broken(self, request, timeout=600.0):
        raise RuntimeError("request broke")

    monkeypatch.setattr(continuous.ContinuousEngine, "submit", broken)
    monkeypatch.setattr(T_text, "PAD_BUCKET", 5)
    closed = []
    close = continuous.ContinuousEngine.close
    monkeypatch.setattr(continuous.ContinuousEngine, "close", lambda self: closed.append(close(self)))
    model = Zonos.from_config(tiny_transformer_config(), dtype=torch.float32, device="cpu")
    ae = DACAutoencoder(cfg=DACConfig(**DAC_KW), dtype=torch.float32, frame_bucket=8, device="cpu", seed=1)
    with pytest.raises(RuntimeError, match="request broke"):
        bench.engine(model, ae, frames=8, requests=2, warm_requests=1)
    assert T_text.PAD_BUCKET == 5 and len(closed) == 1


def test_without_a_card_it_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main([])
