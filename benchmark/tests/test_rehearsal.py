"""A tiny end-to-end rehearsal of every cell on the CPU: the wrapped server
(``ZONOS_PLATFORM=cpu``, tiny seeded checkpoints), the cell's traffic, the
reference check; the last line is well formed. And the planted faults: served
tokens altered where the sampler produces them, or the codec's PCM where it is
produced, make ``correct`` false."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import spec
from benchmark.tests.conftest import REPO

HERE = os.path.dirname(os.path.abspath(__file__))
TINY = {"zonos-v0.1-transformer.int8": "tiny-transformer.json"}


def rehearse(workload: str, tmp, *extra) -> tuple[dict, str]:
    bench = spec.load()
    w = spec.workload(bench, workload)
    env = dict(os.environ, TMPDIR=str(tmp), OMP_NUM_THREADS="2")
    cmd = [sys.executable, "benchmark/run.py", "--workload", workload, "--seed", str(2**31 + 3), "--seconds", "3",
           "--trace", "0", "--platform", "cpu", "--config-file", os.path.join(HERE, TINY[w["config"]]),
           "--rate", "1.0", *extra]
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


@pytest.mark.parametrize("workload", [w["name"] for w in spec.load()["workloads"]])
def test_cell_rehearsal(workload, tmp_path):
    line, err = rehearse(workload, tmp_path)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "setup_built_libraries", "checks"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    checks = line["checks"]
    assert line["correct"] == all(c["value"] <= c["limit"] for k, c in checks.items() if k != "checked_requests")
    # The tokens hold the cell's limit at the tiny size too; the tiny codec
    # (bf16, a few channels) is coarser than the full-size one the limit is for.
    assert checks["token_gap"]["value"] <= checks["token_gap"]["limit"]
    assert checks["pcm_err"]["value"] < 0.2
    names = {m["name"] for m in spec.end_to_end(spec.load(), workload)}
    assert set(line["metrics"]) == names
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert line["checks"]["checked_requests"]["value"] >= 1
    assert "check token_gap" in err.strip().splitlines()[-4]
    assert not os.path.exists(os.path.join(tmp_path, "zonos-benchmark", "server", "model", "model.safetensors")) or \
        os.path.getsize(os.path.join(tmp_path, "zonos-benchmark", "server", "model", "model.safetensors")) == 0


@pytest.mark.parametrize("fault, number", [("token", "token_gap"), ("pcm", "pcm_err")])
def test_altered_answer_is_not_correct(fault, number, tmp_path):
    line, _ = rehearse("tfm-int8.npc-stream.engine", tmp_path, "--fault", fault)
    assert line["correct"] is False
    assert line["checks"][number]["value"] > line["checks"][number]["limit"]
