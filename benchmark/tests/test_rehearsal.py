"""A tiny end-to-end rehearsal of every cell on the CPU: the wrapped server
(``ZONOS_PLATFORM=cpu``, tiny seeded checkpoints), or the fleet cell's four
of them behind the router, the cell's traffic, the reference check; the last
line is well formed. And the planted faults: served tokens altered where the
sampler produces them, or the codec's PCM where it is produced, on every
backend or on one, and a backend's weights unlike those the reference makes
again, make ``correct`` false. A configuration that names a reference module of its own
(and its checkpoint's key), added as files to a copy of the harness, runs
with no harness file edited, and the comparison sees a reference that
differs from the program."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import spec
from benchmark.tests.conftest import REPO

HERE = os.path.dirname(os.path.abspath(__file__))
TINY = {"zonos-v0.1-transformer.int8": "tiny-transformer.json"}


def rehearse(workload: str, tmp, *extra, root: str = REPO, config: str | None = None) -> tuple[dict, str]:
    bench = spec.load()
    w = spec.workload(bench, workload)
    env = dict(os.environ, TMPDIR=str(tmp), OMP_NUM_THREADS="2")
    cmd = [sys.executable, "benchmark/run.py", "--workload", workload, "--seed", str(2**31 + 3), "--seconds", "3",
           "--trace", "0", "--platform", "cpu", "--config-file", config or os.path.join(HERE, TINY[w["config"]]),
           "--rate", "1.0", *extra]
    out = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True, timeout=600)
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
    assert "check token_gap" in err.strip().splitlines()[-len(checks)]
    assert not os.path.exists(os.path.join(tmp_path, "zonos-benchmark", "server", "model", "model.safetensors")) or \
        os.path.getsize(os.path.join(tmp_path, "zonos-benchmark", "server", "model", "model.safetensors")) == 0


@pytest.mark.parametrize("fault, number", [("token", "token_gap"), ("pcm", "pcm_err"),
                                           ("weights", "backends_with_other_weights")])
def test_altered_answer_is_not_correct(fault, number, tmp_path):
    line, _ = rehearse("tfm-int8.npc-stream.engine", tmp_path, "--fault", fault)
    assert line["correct"] is False
    assert line["checks"][number]["value"] > line["checks"][number]["limit"]


@pytest.mark.parametrize("fault, number", [("token@0", "token_gap"), ("weights@1", "backends_with_other_weights")])
def test_a_fault_on_one_backend_is_not_correct(fault, number, tmp_path):
    """The router hands the first request, a greedy one, to the first backend."""
    line, err = rehearse("tfm-int8.npc-stream.fleet4", tmp_path, "--fault", fault)
    assert line["correct"] is False
    assert line["checks"][number]["value"] > line["checks"][number]["limit"]


def copy_with_reference(tmp, module: str) -> tuple[str, str]:
    """A checkout of the harness (``benchmark/``, ``BENCHMARK.json``, the
    program linked in) with ``benchmark/reference/<module>.py`` and a tiny
    configuration naming it and its checkpoint's key added as files; returns
    (root, configuration file)."""
    root = tmp / "checkout"
    shutil.copytree(spec.HERE, root / "benchmark", ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    os.symlink(os.path.join(REPO, "zonos_tpu_torch"), root / "zonos_tpu_torch")
    (root / "benchmark" / "reference" / f"{module}.py").write_text(
        (root / "benchmark" / "reference" / "model.py").read_text())
    with open(os.path.join(HERE, "tiny-transformer.json")) as f:
        doc = dict(json.load(f), reference=module, path_key="PATH_MODEL_TRANSFORMER")
    cfg = root / "benchmark" / "configs" / "tiny-own-reference.json"
    cfg.write_text(json.dumps(doc))
    return str(root), str(cfg)


@pytest.mark.parametrize("residual, correct", [(1.0, True), (0.5, False)])
def test_a_configuration_with_its_own_reference(residual, correct, tmp_path):
    root, cfg = copy_with_reference(tmp_path, "zonos_own")
    ref = os.path.join(root, "benchmark", "reference", "zonos_own.py")
    old = 'return x + (y * F.silu(gate)) @ self.w(f"{base}.mlp.fc2.weight").T'
    text = open(ref).read()
    assert old in text
    with open(ref, "w") as f:
        f.write(text.replace(old, old.replace("x + ", f"x + {residual} * ")))
    line, err = rehearse("tfm-int8.npc-stream.engine", tmp_path / "run", root=root, config=cfg)
    assert line["correct"] is correct
    assert (line["checks"]["token_gap"]["value"] <= line["checks"]["token_gap"]["limit"]) is correct
    with open(os.path.join(tmp_path, "run", "zonos-benchmark", "server", "configmodel.txt")) as f:
        assert f.readline().startswith("PATH_MODEL_TRANSFORMER = ")
