"""The port's kernel modules on the CPU, where each wrapper runs its plain version.

Each plain version is held against the Pallas kernel it replaces, run in
interpret mode at the JAX tests' shapes on bf16-representable inputs, and
against the XLA path that kernel stands in for, at float32. The CUDA kernels
themselves are checked on the card by chip_smoke.py. Also: CPU tensors never
count a launch, and importing the port never runs nvcc.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zonos_tpu.models.transformer import _kv_quantize
from zonos_tpu.ops import attention as JA
from zonos_tpu.ops import quant as JQ
from zonos_tpu.ops.pallas_attention import attn_core_int8 as j_attn_core
from zonos_tpu.ops.pallas_matmul import fused_mlp_int8 as j_fused, fused_mlp_int8_split as j_fused_split
from zonos_tpu.ops.pallas_matmul import int8_matmul as j_int8_matmul
from zonos_tpu_torch.ops import cuda_attention as TA
from zonos_tpu_torch.ops import cuda_matmul as TM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16(a):
    """Round to bf16-representable float32 values."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _quant(rng, k, n):
    return JQ.quantize_int8(jnp.asarray(rng.normal(size=(k, n)).astype(np.float32) / np.sqrt(k)))


@pytest.mark.parametrize("b,k,n", [(2, 256, 512), (16, 128, 384), (1, 256, 130)])
def test_k1_plain_matches_pallas_int8_matmul(b, k, n):
    rng = np.random.default_rng(0)
    x = _bf16(rng.normal(size=(b, k)))
    w = _quant(rng, k, n)
    ref = np.asarray(j_int8_matmul(jnp.asarray(x), w["q"], w["s"], block_n=n if n % 128 else 128, interpret=True))
    got = TM.int8_matmul(_t(x), _t(w["q"]), _t(w["s"])).numpy()
    # bf16 x int8 products are exact in f32 on both sides; only the order of
    # the f32 sums differs: 1e-5 relative to the output's scale.
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_k1_plain_matches_xla_qeinsum_fp32():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 1, 192)).astype(np.float32)
    w = _quant(rng, 192, 256)
    ref = JQ.qeinsum("bsd,de->bse", jnp.asarray(x), w)[:, 0]
    got = TM.int8_matmul(_t(x[:, 0]), _t(w["q"]), _t(w["s"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5 * float(np.abs(ref).max()))


def _kv(rng, b, s, hkv, dh):
    kq, ks = _kv_quantize(jnp.asarray(rng.normal(size=(b, s, hkv, dh)).astype(np.float32)) * 2.0)
    vq, vs = _kv_quantize(jnp.asarray(rng.normal(size=(b, s, hkv, dh)).astype(np.float32)))
    return (jnp.swapaxes(kq, 1, 2), jnp.swapaxes(ks, 1, 2), jnp.swapaxes(vq, 1, 2), jnp.swapaxes(vs, 1, 2))


@pytest.mark.parametrize("b,s,hq,hkv,dh", [(2, 16, 4, 2, 128), (1, 32, 8, 2, 128), (4, 8, 4, 4, 128)])
def test_k2_plain_matches_pallas_attn_core(b, s, hq, hkv, dh):
    rng = np.random.default_rng(0)
    q = _bf16(rng.normal(size=(b, 1, hq, dh)))
    kq, ks, vq, vs = _kv(rng, b, s, hkv, dh)
    pad = rng.integers(0, 3, size=(b,)).astype(np.int32)
    wi = s - 3
    ref = np.asarray(j_attn_core(jnp.asarray(q), kq, ks, vq, vs, jnp.int32(wi), jnp.asarray(pad), interpret=True))
    got = TA.attn_core_int8(_t(q).to(torch.bfloat16), _t(kq), _t(ks), _t(vq), _t(vs),
                            torch.tensor([wi], dtype=torch.int32), _t(pad)).float().numpy()
    # The JAX kernel test's own bar (tests/test_pallas_attention.py): both round
    # p * vs to bf16, at slightly different points of the softmax.
    np.testing.assert_allclose(got, ref.astype(np.float32), rtol=2e-2, atol=2e-2)
    assert np.corrcoef(got.ravel(), ref.astype(np.float32).ravel())[0, 1] > 0.9995


@pytest.mark.parametrize("gap", [None, [3, 0]])
def test_k2_plain_matches_xla_attention_fp32(gap):
    rng = np.random.default_rng(2)
    b, s, hq, hkv, dh = 2, 40, 8, 2, 32
    q = rng.normal(size=(b, 1, hq, dh)).astype(np.float32)
    kq, ks, vq, vs = _kv(rng, b, s, hkv, dh)
    pad = np.array([1, 4], np.int32)
    gl = None if gap is None else np.array(gap, np.int32)
    mask = JA.decode_mask(s, jnp.asarray(pad), jnp.int32(30), gap_start=12,
                          gap_len=None if gl is None else jnp.asarray(gl))
    ref = np.asarray(JA.gqa_attention_quantized(jnp.asarray(q), kq, ks, vq, vs, mask))
    got = TA.attn_core_int8(_t(q), _t(kq), _t(ks), _t(vq), _t(vs), torch.tensor([30], dtype=torch.int32),
                            _t(pad), gap_start=12, gap_len=None if gl is None else _t(gl)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("b,d,f,bf", [(2, 128, 256, 128), (1, 256, 512, 256), (8, 128, 512, 128)])
def test_k3_plain_matches_pallas_fused_mlp(b, d, f, bf):
    rng = np.random.default_rng(0)
    x = _bf16(rng.normal(size=(b, d)))
    w1, w2 = _quant(rng, d, 2 * f), _quant(rng, f, d)
    xb = _t(x).to(torch.bfloat16)
    ref = np.asarray(j_fused(jnp.asarray(x, jnp.bfloat16), w1["q"], w1["s"], w2["q"], w2["s"], block_f=bf, interpret=True))
    got = TM.fused_mlp_int8(xb, _t(w1["q"]), _t(w1["s"]), _t(w2["q"]), _t(w2["s"])).numpy()
    # Both round h to bf16; a y or gate summed in another order can round one
    # element of h an ulp apart (the JAX multichunk test's 2e-2 bar).
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-2)

    s1 = np.asarray(w1["s"]).reshape(-1)
    w1q = np.asarray(w1["q"])
    ref_s = np.asarray(j_fused_split(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w1q[:, :f]), jnp.asarray(s1[:f]), jnp.asarray(w1q[:, f:]),
        jnp.asarray(s1[f:]), w2["q"], w2["s"], block_f=bf, interpret=True))
    got_s = TM.fused_mlp_int8_split(xb, _t(w1q[:, :f]), _t(s1[:f]), _t(w1q[:, f:]), _t(s1[f:]),
                                    _t(w2["q"]), _t(w2["s"])).numpy()
    np.testing.assert_allclose(got_s, ref_s, rtol=2e-2, atol=2e-2)
    np.testing.assert_array_equal(got_s, got)  # one body, two weight layouts


def test_k3_plain_matches_xla_mlp_fp32():
    rng = np.random.default_rng(3)
    b, d, f = 2, 64, 128
    x = rng.normal(size=(b, 1, d)).astype(np.float32)
    w1, w2 = _quant(rng, d, 2 * f), _quant(rng, f, d)
    yg = JQ.qeinsum("bsd,de->bse", jnp.asarray(x), w1)
    y, g = jnp.split(yg, 2, axis=-1)
    ref = np.asarray(JQ.qeinsum("bsf,fd->bsd", y * jax.nn.silu(g), w2))[:, 0]
    got = TM.fused_mlp_int8(_t(x[:, 0]), _t(w1["q"]), _t(w1["s"]), _t(w2["q"]), _t(w2["s"])).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_cpu_tensors_count_no_launch():
    rng = np.random.default_rng(4)
    kernels = (TM.int8_matmul, TM.fused_mlp_int8, TM.fused_mlp_int8_split, TA.attn_core_int8)
    before = [k.launches for k in kernels]
    x = torch.randn(2, 64)
    w = {k: _t(v) for k, v in _quant(rng, 64, 64).items()}
    TM.int8_matmul(x, w["q"], w["s"])
    TM.fused_mlp_int8(x, torch.cat([w["q"], w["q"]], 1), torch.cat([w["s"], w["s"]], 1), w["q"], w["s"])
    TM.fused_mlp_int8_split(x, w["q"], w["s"], w["q"], w["s"], w["q"], w["s"])
    kq, ks, vq, vs = (_t(a) for a in _kv(rng, 2, 8, 2, 16))
    TA.attn_core_int8(torch.randn(2, 1, 4, 16), kq, ks, vq, vs, torch.tensor([5], dtype=torch.int32),
                      torch.zeros(2, dtype=torch.int32))
    assert [k.launches for k in kernels] == before == [0, 0, 0, 0]


def test_import_never_runs_nvcc(tmp_path):
    fake_bin = tmp_path / "bin"
    fake_bin.mkdir()
    marker = tmp_path / "nvcc_ran"
    nvcc = fake_bin / "nvcc"
    nvcc.write_text(f"#!/bin/sh\ntouch {marker}\nexit 1\n")
    nvcc.chmod(0o755)
    code = textwrap.dedent("""
        import importlib, pkgutil, torch
        import zonos_tpu_torch
        for m in pkgutil.walk_packages(zonos_tpu_torch.__path__, "zonos_tpu_torch."):
            importlib.import_module(m.name)
        from zonos_tpu_torch.ops import cuda_matmul
        cuda_matmul.int8_matmul(torch.ones(1, 4), torch.ones(4, 4, dtype=torch.int8), torch.ones(4))
        print("imported")
    """)
    env = dict(os.environ, PATH=f"{fake_bin}{os.pathsep}{os.environ['PATH']}", CUDA_HOME=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "imported" in out.stdout
    assert not marker.exists()
