"""``zonos_tpu_torch.tools.export_checkpoint`` against the JAX package, on the CPU.

A tiny transformer drawn by JAX is bridged into the port, saved as the port's
native checkpoint and exported by the command; the JAX package reads the
export. Everything is written under the test's own directory.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zonos_tpu.config import tiny_transformer_config as j_tiny
from zonos_tpu.models.zonos import Zonos as JZonos
from zonos_tpu.ops.sampling import SamplingParams as JSP
from zonos_tpu.runtime import generate as JG
from zonos_tpu.utils import export as JE
from zonos_tpu_torch.bridge import params_from_jax
from zonos_tpu_torch.config import tiny_transformer_config
from zonos_tpu_torch.models.zonos import Zonos
from zonos_tpu_torch.ops.sampling import SamplingParams
from zonos_tpu_torch.runtime import generate as TG
from zonos_tpu_torch.tools import export_checkpoint
from zonos_tpu_torch.utils.checkpoint import save_checkpoint
from zonos_tpu_torch.utils.safetensors_io import load_file

# the Fourier conditioners' weights: F32 in the port's export whatever the model's dtype (bf16 in JAX's)
F32_LEAVES = {f"prefix_conditioner.conditioners.{i}.weight"
              for i, c in enumerate(tiny_transformer_config().prefix_conditioner.conditioners)
              if c.type == "FourierConditioner"}


@pytest.fixture(scope="module")
def jax_model():
    return JZonos.from_config(j_tiny(), seed=0, dtype=jnp.float32)


def _export(jm, tmp_path, dtype):
    """The JAX model bridged into the port at ``dtype``, saved natively and
    exported by the command; returns (port model, export directory)."""
    tm = Zonos(tiny_transformer_config(), params_from_jax(jax.tree.map(np.asarray, jm.params), dtype=dtype),
               dtype=dtype, device="cpu")
    native, out = tmp_path / "native", tmp_path / "ref"
    save_checkpoint(str(native), tm.params, tm.config)
    assert export_checkpoint.main(["--checkpoint", str(native), "--out", str(out), "--device", "cpu"]) == 0
    return tm, out


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _leaves(v, f"{path}/{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _leaves(v, f"{path}[{i}]")]
    return [] if tree is None else [(path, tree)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_export_loads_in_both_packages_with_equal_greedy_codes(jax_model, tmp_path, capsys, dtype):
    """The export of a ``dtype`` model, read by each package's from_local at
    f32: the same greedy codes. A bf16 model reads back at bf16 bit for bit
    (the embeddings on the reference's 1026 rows)."""
    src, out = _export(jax_model, tmp_path, dtype)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"exported {out / 'model.safetensors'} (") and line.endswith(f" MB) + {out / 'config.json'}")
    cpath, wpath = str(out / "config.json"), str(out / "model.safetensors")
    back = JZonos.from_local(cpath, wpath, dtype=jnp.float32)
    tm = Zonos.from_local(cpath, wpath, dtype=torch.float32, device="cpu")
    cond = np.random.default_rng(1).normal(size=(2, 9, 64)).astype(np.float32) * 0.5
    ref = JG.generate(back.params, back.config, cond, max_new_tokens=16, sampling_params=JSP(temperature=0.0),
                      seed=0, dtype=jnp.float32)
    got = TG.generate(tm.params, tm.config, cond, max_new_tokens=16, sampling_params=SamplingParams(temperature=0.0),
                      seed=0, dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(got, ref)
    if dtype == torch.bfloat16:
        loaded = Zonos.from_local(cpath, wpath, dtype=dtype, device="cpu")
        want, have = dict(_leaves(src.params)), dict(_leaves(loaded.params))
        assert sorted(want) == sorted(have)
        for path, a in want.items():
            b = have[path]
            if path == "/embeddings":
                a, b = a[:, :1026], b[:, :1026]
            assert a.dtype == b.dtype and torch.equal(a, b), path


def test_export_tensors_match_the_jax_exporter(jax_model, tmp_path):
    """Names, shapes and dtypes equal those of JAX's save_reference_checkpoint
    on the same params, values bit-equal; the documented f32 leaves are F32
    here and their bf16 rounding there."""
    _tm, out = _export(jax_model, tmp_path, torch.float32)
    JE.save_reference_checkpoint(str(tmp_path / "jax"), jax_model.params, jax_model.config)
    got, ref = load_file(str(out / "model.safetensors")), load_file(str(tmp_path / "jax" / "model.safetensors"))
    assert sorted(got) == sorted(ref) and F32_LEAVES <= set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        if k in F32_LEAVES:
            assert got[k].dtype == torch.float32 and ref[k].dtype == torch.bfloat16, k
            assert torch.equal(got[k].to(torch.bfloat16), ref[k]), k
        else:
            assert got[k].dtype == ref[k].dtype == torch.bfloat16, k
            assert torch.equal(got[k], ref[k]), k


def test_missing_config_exits_with_the_message(jax_model, tmp_path, capsys):
    tm = Zonos(tiny_transformer_config(), params_from_jax(jax.tree.map(np.asarray, jax_model.params)),
               dtype=torch.float32, device="cpu")
    save_checkpoint(str(tmp_path), tm.params)  # no config
    assert export_checkpoint.main(["--checkpoint", str(tmp_path), "--out", str(tmp_path / "ref"),
                                   "--device", "cpu"]) == 1
    assert capsys.readouterr().err.strip() == f"no config.json in {tmp_path}"
    assert not os.path.exists(tmp_path / "ref")
