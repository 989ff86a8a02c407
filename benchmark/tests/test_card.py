"""On the card (``python -m pytest benchmark/tests -q -m card``): the
control against each cell's limits at the cell's own size, on one seed and a
short window. The program's readings make ``correct`` true; the control's
(int4 weights and KV, an fp8 codec, on the same served requests), judged by
the harness's same expression, make it false."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import spec
from benchmark.tests.conftest import REPO


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in spec.load()["workloads"]])
def test_control_fails_the_limits(workload, card, tmp_path):
    import torch

    chips = spec.workload(spec.load(), workload)["chips"]
    if torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA devices")
    env = dict(os.environ, TMPDIR=str(tmp_path))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload, "--seed", "2718281828",
                          "--seconds", "12", "--trace", "0", "--control", "1"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(x) for x in out.stdout.strip().splitlines()]
    result, control = lines[-1], next(x for x in lines if "control" in x)
    assert result["correct"] is True
    assert control["control_correct"] is False
