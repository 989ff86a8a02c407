"""No module the harness, the server wrapper or the reference loads has
jax, jaxlib, flax or zonos_tpu as its top-level name; the port's own name,
which begins with the JAX package's, is not caught."""

import subprocess
import sys

from benchmark import isolation
from benchmark.tests.conftest import REPO


def test_names_compare_whole():
    mods = ["zonos_tpu_torch", "zonos_tpu_torch.serving.server", "jaxtyping", "flaxen", "numpy"]
    assert isolation.forbidden_modules(mods) == []
    assert isolation.forbidden_modules(mods + ["zonos_tpu.models", "jax._src", "flax"]) == [
        "flax", "jax._src", "zonos_tpu.models"]


def test_harness_wrapper_and_reference_import_no_jax():
    code = ("import benchmark.run, benchmark.check, benchmark.knee, benchmark.reference.model, "
            "benchmark.reference.codec, benchmark.weights, benchmark.serve, "
            "zonos_tpu_torch.serving.server, zonos_tpu_torch.serving.continuous; "
            "from benchmark.isolation import forbidden_modules; print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, benchmark.check, benchmark.reference.model, benchmark.reference.codec; "
            "print(sorted(m for m in sys.modules if m.split('.')[0].startswith('zonos')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
