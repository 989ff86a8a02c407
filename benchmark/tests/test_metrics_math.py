"""The end-to-end arithmetic on hand-made arrival traces, and the per-layer
readers on a hand-made trace."""

import numpy as np
import pytest

from benchmark import check, run
from benchmark.tracedata import Context


def rec(rid, due, first, last, seconds_of_audio, error=None, sr=44100):
    return {"id": rid, "due": due, "sent": due, "first": first, "last": last,
            "pcm": b"\0\0" * int(seconds_of_audio * sr), "sr": sr, "error": error}


def test_p90_interpolates():
    assert run.p90(list(range(11))) == pytest.approx(9.0)
    assert run.p90([5.0]) == 5.0


def test_stream_metrics_with_a_failed_request():
    t0 = 100.0
    rs = [rec(i, t0 + i, t0 + i + 0.5, t0 + i + 0.5 + 3.0, 2.0) for i in range(9)]
    rs.append(rec(9, t0 + 9, None, None, 0.0, error="HTTP 500"))
    m = run.end_to_end(rs, cap_s=60, seconds=10, t0=t0, loop="open")
    # TTFA: nine of 500 ms and one failed at the 60 s cap; p90 interpolates between them.
    assert m["ttfa_p90_ms"] == pytest.approx(500 + 0.1 * (60000 - 500))
    # Stall: 3 s of streaming for 2 s of audio → 1 s each.
    assert m["stall_p90_ms"] == pytest.approx(1000 + 0.1 * (60000 - 1000))
    assert m["audio_s_per_s"] == pytest.approx(18 / 10)
    # Streamed seconds over audio seconds: nine of 3 s for 2 s, and the failed one for the cap.
    assert m["stream_s_per_audio_s"] == pytest.approx((9 * 3.0 + 60) / 18)


def test_stall_is_floored_at_zero_and_solo_rate():
    t0 = 0.0
    rs = [rec(0, 0.0, 1.0, 1.5, 2.0), rec(1, 1.5, 4.0, 4.0, 3.0)]
    m = run.end_to_end(rs, 60, 10, t0, "open")
    assert m["stall_p90_ms"] == 0.0
    m = run.end_to_end(rs, 60, 3, t0, "closed")
    assert m["rtf_solo"] == pytest.approx(5.0 / 4.0)


def test_every_frame_is_taken_from_its_window():
    hop = check.HOP
    a, b = np.arange(4 * hop, dtype=np.float32), -np.arange(3 * hop, dtype=np.float32)
    wav = check.assemble([a, b], [[0, 2], [0, 3], [1, 0], [1, 1]])
    assert np.array_equal(wav, np.concatenate([a[2 * hop:], b[: 2 * hop]]))
    # A sent frame that differs from its window's reference frame shows, at a seam too.
    got = wav.copy()
    got[2 * hop: 2 * hop + 10] += 100.0
    err = check.frame_errors(got, wav)
    assert err.shape == (4,) and err[2] > 0 and err[0] == err[1] == err[3] == 0


def trace(kernels, ranges, steps=(), t0=0.0, t1=1e6):
    names = sorted({k[0] for k in kernels})
    return {"names": names, "kernels": [[names.index(n), s, e] for n, s, e in kernels], "ranges": ranges,
            "steps": list(steps), "slice": [t0, t1]}


def test_readers_on_a_hand_made_trace():
    from benchmark import spec

    cfg = {"backbone": {"d_model": 64, "n_layer": 2, "attn_layer_idx": [0, 1], "d_intermediate": 0,
                        "attn_mlp_d_intermediate": 128, "attn_cfg": {"num_heads": 4, "num_heads_kv": 2}},
           "codebook_dimension": 9, "eos_token_id": 1024}
    # Two steps in 1 s: per step 2 × (K1, K1, K3 fc1, K3 fc2), heads K1, and one other kernel.
    ks, t = [], 0.0
    for _ in range(2):
        for name in ["void int8_gemv_cluster<1>", "void int8_gemv_cluster<1>", "mlp_fc1_gate",
                     "void int8_gemv_cluster<2>"] * 2 + ["void int8_gemv_cluster<1>", "elementwise"]:
            ks.append((name, t, t + 10.0))
            t += 100.0
    ctx = Context(trace(ks, [["engine.segment_dispatch", 1, 0.0, 1000.0]], steps=[0.0, 500.0]), cfg, 2)
    assert ctx.steps() == 2
    assert spec.reader("engine.step_ms")(ctx) == pytest.approx(500.0)
    assert spec.reader("launches_per_step.engine")(ctx) == pytest.approx(10.0)
    assert spec.reader("device_idle.engine")(ctx) == pytest.approx(100 * (1 - 200e-6 / 1.0))
    r = spec.reader("kernels_roofline.engine")(ctx)
    assert 0 < r <= 100
    names = {n for _, n in ctx.idle_gaps()}
    assert names == {"engine.segment_dispatch", "host:none"}


def test_steps_are_counted_without_any_kernel_name():
    """The step count comes from the wrapper's marks: a trace whose decode
    steps run no K1 or K3 still gives the step time and the launches."""
    from benchmark import spec

    cfg = {"backbone": {"d_model": 64, "n_layer": 1, "attn_layer_idx": [0], "attn_mlp_d_intermediate": 8,
                        "d_intermediate": 0, "attn_cfg": {"num_heads": 4, "num_heads_kv": 2}},
           "codebook_dimension": 9, "eos_token_id": 1024}
    ks = [("library_gemm", 100.0 * i, 100.0 * i + 20.0) for i in range(8)]
    ctx = Context(trace(ks, [], steps=[0.0, 250.0, 500.0, 750.0]), cfg, 2)
    assert spec.reader("solo.frame_ms")(ctx) == pytest.approx(250.0)
    assert spec.reader("launches_per_step.solo")(ctx) == pytest.approx(2.0)
    assert spec.reader("mfu_roofline.solo")(ctx) > 0
    assert spec.reader("kernels_roofline.solo")(ctx) is None


def test_readers_find_nothing_without_kernels():
    from benchmark import spec

    ctx = Context(trace([], []), {"backbone": {"d_model": 64, "n_layer": 1, "attn_layer_idx": [0],
                                               "attn_mlp_d_intermediate": 8, "d_intermediate": 0,
                                               "attn_cfg": {"num_heads": 4, "num_heads_kv": 2}},
                                  "codebook_dimension": 9, "eos_token_id": 1024}, 2)
    for name in ("engine.step_ms", "kernels_roofline.solo", "device_idle.solo", "mfu_roofline.engine"):
        assert spec.reader(name)(ctx) is None
