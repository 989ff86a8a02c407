"""The configuration ``granite-4.0-h-micro.zonos-int8`` and its cell
``granite-h-micro-int8.npc-stream.engine``: found by name with the reference
module and checkpoint key its file names, at the published widths; a CPU
rehearsal of the cell on ``tiny-granite.json`` (a tiny model of the same
layers, Granite's scalars at non-unit values) in which a planted fault is
not correct (``test_rehearsal`` holds the same rehearsal correct), and a
traced one in which the engine's span metrics read a value; and, on the
card, K2 at head dim 64 against its plain version."""

import json
import math
import os
import subprocess
import sys

import pytest

from benchmark import roofline_ssm, spec
from benchmark.tests.conftest import REPO
from benchmark.tests.test_rehearsal import HERE, rehearse

CELL = "granite-h-micro-int8.npc-stream.engine"
CONFIG = "granite-4.0-h-micro.zonos-int8"
TINY = os.path.join(HERE, "tiny-granite.json")


def _doc() -> dict:
    with open(spec.config_path(spec.load(), CONFIG)) as f:
        return json.load(f)


def test_the_cell_its_configuration_and_reference_are_found():
    bench = spec.load()
    w = spec.workload(bench, CELL)
    assert w["config"] == CONFIG and w["chips"] == 1
    assert spec.cell(CELL)["rows"] == 32
    doc = _doc()
    assert doc["reference"] == "granite_h" and doc["path_key"] == "PATH_MODEL_HYBRID"
    assert "hybrid" in doc["model_choice"]
    names = [m["name"] for m in spec.end_to_end(bench, CELL)]
    assert sorted(names) == ["audio_s_per_s", "setup_s", "stream_s_per_audio_s", "ttfa_p90_ms"]
    assert [m["name"] for m in spec.per_layer(bench, CELL, names)] == [
        "engine.step_ms", "launches_per_step.engine", "kernels_roofline.engine", "device_idle.engine",
        "front.handler_ms", "prep.ms", "engine.join_wait_ms", "engine.first_audio_ms", "ship.lag_ms",
        "engine.step_host_ms", "engine.status_wait_ms", "device_idle.in_step.engine", "mfu_roofline.granite",
        "glue_share.granite"]
    ref = spec.reference(doc)
    assert callable(ref.weight_specs) and "ZonosReference" in [c.__name__ for c in ref.Reference.__mro__]


def test_the_backbone_holds_the_published_numbers():
    """The served backbone against the published config.json's keys, which
    the file keeps at its top level."""
    doc = _doc()
    bb = doc["config"]["backbone"]
    ssm, attn = bb["ssm_cfg"], bb["attn_cfg"]
    assert bb["d_model"] == doc["hidden_size"] and bb["n_layer"] == doc["num_hidden_layers"]
    assert bb["attn_layer_idx"] == [i for i, t in enumerate(doc["layer_types"]) if t == "attention"]
    assert bb["d_intermediate"] == bb["attn_mlp_d_intermediate"] == doc["shared_intermediate_size"]
    assert (ssm["d_state"], ssm["d_conv"], ssm["expand"], ssm["headdim"], ssm["ngroups"], ssm["chunk_size"]) == (
        doc["mamba_d_state"], doc["mamba_d_conv"], doc["mamba_expand"], doc["mamba_d_head"], doc["mamba_n_groups"],
        doc["mamba_chunk_size"])
    assert ssm["expand"] * bb["d_model"] // ssm["headdim"] == doc["mamba_n_heads"]
    assert (attn["num_heads"], attn["num_heads_kv"], attn["head_dim"]) == (
        doc["num_attention_heads"], doc["num_key_value_heads"], doc["hidden_size"] // doc["num_attention_heads"])
    assert attn["rotary_emb_dim"] is None and doc["position_embedding_type"] == "nope"
    assert bb["rms_norm"] and bb["rms_norm_f"] and bb["norm_epsilon"] == doc["rms_norm_eps"]
    for k in ("embedding_multiplier", "residual_multiplier", "attention_multiplier", "logits_scaling"):
        assert bb[k] == doc[k]
    assert doc["reduced"] == ["vocab_size", "tie_word_embeddings"]


def test_weights_and_state_at_the_published_widths():
    doc = _doc()
    specs = spec.reference(doc).weight_specs(doc["config"], doc["phoneme_vocab_size"])
    names = [n for n, _, _ in specs]
    assert sum(n.endswith("mixer.conv1d.bias") for n in names) == 36
    assert sum(n.endswith("mlp.fc1.weight") for n in names) == 40
    assert not [n for n in names if n.startswith("backbone.") and n.endswith(".bias") and "conv1d" not in n]
    backbone = sum(math.prod(s) for n, s, _ in specs if n.startswith("backbone."))
    assert 2.98e9 < backbone < 3.0e9
    # 36 layers x (64 x 128 x 64 SSD + 3 x 4352 conv) x 2 bytes
    assert roofline_ssm.state_bytes_per_row(doc["config"]) == 38_688_768


def test_a_planted_fault_in_the_cell_rehearsal_is_not_correct(tmp_path):
    """``test_rehearsal.test_cell_rehearsal`` holds this cell's rehearsal
    correct; here its served tokens are altered."""
    line, _ = rehearse(CELL, tmp_path, "--fault", "token", config=TINY)
    assert line["correct"] is False and line["failed"] == 0
    assert line["checks"]["token_gap"]["value"] > line["checks"]["token_gap"]["limit"]
    with open(os.path.join(tmp_path, "zonos-benchmark", "server", "configmodel.txt")) as f:
        assert f.readline().startswith("PATH_MODEL_HYBRID = ")


def test_a_traced_rehearsal_reports_the_engine_span_metrics(tmp_path):
    """The engine cell's metrics read from the program's spans alone read a
    value on this cell too (on the CPU the slice has no device kernel, so
    the device metrics stay out)."""
    env = dict(os.environ, TMPDIR=str(tmp_path), OMP_NUM_THREADS="2")
    cmd = [sys.executable, "benchmark/run.py", "--workload", CELL, "--seed", str(2**31 + 11), "--seconds", "10",
           "--trace", "1", "--platform", "cpu", "--config-file", TINY, "--rate", "0.5"]
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["failed"] == 0
    for name in ("front.handler_ms", "prep.ms", "engine.join_wait_ms", "engine.first_audio_ms", "ship.lag_ms",
                 "engine.step_host_ms", "engine.status_wait_ms"):
        assert line["metrics"][name]["value"] > 0, name


@pytest.mark.card
def test_k2_at_head_dim_64_matches_its_plain_version(card):
    """K2 at Granite's attention (8 KV heads, 32 query heads of 64, its scale
    1/64), 32 rows of a 1024-slot view with a per-row dead span, against its
    plain version: within one bf16 ulp of the output, as chip_smoke's K2 cases."""
    import torch

    from zonos_tpu_torch.models.transformer import _kv_quantize
    from zonos_tpu_torch.ops import cuda_attention as A

    gen = torch.Generator(device="cuda").manual_seed(0)
    b, s, hkv, hq, dh, view = 32, 3328, 8, 32, 64, 1024
    q = torch.randn((b, 1, hq, dh), generator=gen, device="cuda").to(torch.bfloat16)
    kq, ks = _kv_quantize(torch.randn((b, s, hkv, dh), generator=gen, device="cuda") * 2.0)
    vq, vs = _kv_quantize(torch.randn((b, s, hkv, dh), generator=gen, device="cuda"))
    kq, vq = kq.transpose(1, 2).contiguous()[:, :, :view], vq.transpose(1, 2).contiguous()[:, :, :view]
    ks, vs = ks.transpose(1, 2).contiguous()[:, :, :view], vs.transpose(1, 2).contiguous()[:, :, :view]
    pad = torch.randint(0, 200, (b,), generator=gen, device="cuda", dtype=torch.int32)
    gap = torch.randint(0, 600, (b,), generator=gen, device="cuda", dtype=torch.int32)
    wi = torch.tensor([1000], dtype=torch.int32, device="cuda")
    for scale in (None, 1 / 64):
        args = (q, kq, ks, vq, vs, wi, pad, 256, gap, scale)
        out, ref = A.attn_core_int8(*args).float(), A.attn_core_int8_plain(*args).float()
        torch.cuda.synchronize()
        tol = torch.clamp(2.0**-7 * ref.abs() + 2.0**-12, max=2e-2)
        assert bool(((out - ref).abs() <= tol).all()), float((out - ref).abs().max())
