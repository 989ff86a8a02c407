"""The port's Mamba2 ops (``zonos_tpu_torch/ops/mamba2.py``) against the JAX
package's (``zonos_tpu/ops/mamba2.py``) on the same numpy inputs, float32 on
the CPU, at atol/rtol 1e-5: the conv prefill and step, the chunked SSD scan
(aligned and unaligned lengths, with and without an initial state), the SSD
step, the gated norm, the dt_limit clamp, the whole mixer (prefill, step,
left-pad mask) and the init's shapes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zonos_tpu.config import SSMConfig as JSSM
from zonos_tpu.ops import mamba2 as JM
from zonos_tpu_torch.bridge import params_from_jax
from zonos_tpu_torch.config import SSMConfig
from zonos_tpu_torch.ops import mamba2 as TM

TOL = dict(rtol=1e-5, atol=1e-5)
CFG_J = JSSM(d_state=16, headdim=16, chunk_size=8)
CFG_T = SSMConfig(d_state=16, headdim=16, chunk_size=8)
D_MODEL = 64


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, ref):
    np.testing.assert_allclose(got.numpy() if isinstance(got, torch.Tensor) else got, np.asarray(ref), **TOL)


def _ssd_inputs(seed, b=2, length=24, h=4, p=8, g=2, n=16):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, length, h, p)).astype(np.float32),
            rng.uniform(0.01, 0.3, size=(b, length, h)).astype(np.float32),
            -rng.uniform(0.5, 4.0, size=(h,)).astype(np.float32),
            rng.normal(size=(b, length, g, n)).astype(np.float32),
            rng.normal(size=(b, length, g, n)).astype(np.float32))


@pytest.fixture(scope="module")
def mixer():
    p = JM.init_mamba2_params(jax.random.key(3), D_MODEL, CFG_J, jnp.float32)
    jp = jax.tree.map(np.asarray, p)
    return p, params_from_jax(jp)


@pytest.mark.parametrize("length", [1, 7, 16])
def test_conv_prefill_and_step_match_jax(length):
    rng = np.random.default_rng(length)
    x = rng.normal(size=(2, length, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    b = rng.normal(size=(12,)).astype(np.float32)
    state = rng.normal(size=(2, 3, 12)).astype(np.float32)
    y, s = TM.causal_conv1d_prefill(_t(x), _t(w), _t(b), _t(state))
    ry, rs = JM.causal_conv1d_prefill(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), jnp.asarray(state))
    _close(y, ry)
    _close(s, rs)
    y1, s1 = TM.causal_conv1d_step(_t(x[:, 0]), _t(w), _t(b), _t(state))
    ry1, rs1 = JM.causal_conv1d_step(jnp.asarray(x[:, 0]), jnp.asarray(w), jnp.asarray(b), jnp.asarray(state))
    _close(y1, ry1)
    _close(s1, rs1)


@pytest.mark.parametrize("chunk", [4, 8, 24])
@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_chunked_aligned_matches_jax(chunk, with_init):
    x, dt, A, B_, C_ = _ssd_inputs(chunk)
    init = np.random.default_rng(9).normal(size=(2, 4, 16, 8)).astype(np.float32) if with_init else None
    y, st = TM.ssd_chunked(_t(x), _t(dt), _t(A), _t(B_), _t(C_), chunk, None if init is None else _t(init))
    ry, rst = JM.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, B_, C_)), chunk,
                             None if init is None else jnp.asarray(init))
    _close(y, ry)
    _close(st, rst)


@pytest.mark.parametrize("length", [5, 13, 21])
@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_chunked_unaligned_length(length, with_init):
    """The port pads the tail chunk itself (dt = 0 there); JAX is given the
    padded inputs: the same outputs on the valid positions and the same state."""
    x, dt, A, B_, C_ = _ssd_inputs(length, length=length)
    init = np.random.default_rng(4).normal(size=(2, 4, 16, 8)).astype(np.float32) if with_init else None
    y, st = TM.ssd_chunked(_t(x), _t(dt), _t(A), _t(B_), _t(C_), 8, None if init is None else _t(init))
    pad = (-length) % 8

    def padded(a):
        return jnp.asarray(np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2)))

    ry, rst = JM.ssd_chunked(padded(x), padded(dt), jnp.asarray(A), padded(B_), padded(C_), 8,
                             None if init is None else jnp.asarray(init))
    assert y.shape == x.shape
    _close(y, np.asarray(ry)[:, :length])
    _close(st, rst)


def test_ssd_chunk_boundary_continuity_with_init_state():
    """Two halves, the second started from the first's state, equal one pass."""
    x, dt, A, B_, C_ = (_t(a) for a in _ssd_inputs(11, length=24))
    y, st = TM.ssd_chunked(x, dt, A, B_, C_, 8)
    y1, s1 = TM.ssd_chunked(x[:, :16], dt[:, :16], A, B_[:, :16], C_[:, :16], 8)
    y2, s2 = TM.ssd_chunked(x[:, 16:], dt[:, 16:], A, B_[:, 16:], C_[:, 16:], 8, init_state=s1)
    _close(torch.cat([y1, y2], dim=1), y.numpy())
    _close(s2, st.numpy())


def test_ssd_step_matches_jax():
    x, dt, A, B_, C_ = _ssd_inputs(2, length=1)
    state = np.random.default_rng(5).normal(size=(2, 4, 16, 8)).astype(np.float32)
    y, st = TM.ssd_step(_t(x[:, 0]), _t(dt[:, 0]), _t(A), _t(B_[:, 0]), _t(C_[:, 0]), _t(state))
    ry, rst = JM.ssd_step(*(jnp.asarray(a) for a in (x[:, 0], dt[:, 0], A, B_[:, 0], C_[:, 0], state)))
    _close(y, ry)
    _close(st, rst)


def test_gated_rms_norm_matches_jax():
    rng = np.random.default_rng(6)
    y, z = rng.normal(size=(2, 5, 32)).astype(np.float32), rng.normal(size=(2, 5, 32)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, size=(32,)).astype(np.float32)
    _close(TM._gated_rms_norm(_t(y), _t(z), _t(w), 1e-5), JM._gated_rms_norm(jnp.asarray(y), jnp.asarray(z),
                                                                             jnp.asarray(w), 1e-5))


@pytest.mark.parametrize("limit", [(0.0, float("inf")), (0.05, float("inf")), (0.0, 0.02), (0.01, 0.05)])
def test_dt_limit_clamp_matches_jax(mixer, limit):
    jp, tp = mixer
    cj, ct = dataclasses.replace(CFG_J, dt_limit=limit), dataclasses.replace(CFG_T, dt_limit=limit)
    dt = np.random.default_rng(7).uniform(0.0, 0.1, size=(2, 9, 8)).astype(np.float32)
    _close(TM._clamp_dt(_t(dt), ct), JM._clamp_dt(jnp.asarray(dt), cj))
    x = np.random.default_rng(8).normal(size=(2, 11, D_MODEL)).astype(np.float32)
    out = TM.mamba2_prefill(tp, _t(x), ct)
    ref = JM.mamba2_prefill(jp, jnp.asarray(x), cj)
    for got, want in zip(out, ref):
        _close(got, want)


@pytest.mark.parametrize("length", [8, 13])
def test_mixer_prefill_and_steps_match_jax(mixer, length):
    """The mixer over a sequence (aligned and not) against JAX, then 4 steps
    from its states against JAX's steps and against the port's own prefill
    of the longer sequence."""
    jp, tp = mixer
    x = np.random.default_rng(length).normal(size=(2, length + 4, D_MODEL)).astype(np.float32) * 0.5
    y, conv, ssm = TM.mamba2_prefill(tp, _t(x[:, :length]), CFG_T)
    ry, rconv, rssm = JM.mamba2_prefill(jp, jnp.asarray(x[:, :length]), CFG_J)
    for got, want in ((y, ry), (conv, rconv), (ssm, rssm)):
        _close(got, want)
    steps = []
    for t in range(length, length + 4):
        yt, conv, ssm = TM.mamba2_step(tp, _t(x[:, t:t + 1]), CFG_T, conv, ssm)
        ryt, rconv, rssm = JM.mamba2_step(jp, jnp.asarray(x[:, t:t + 1]), CFG_J, rconv, rssm)
        _close(yt, ryt)
        _close(ssm, rssm)
        steps.append(yt)
    full, _, _ = TM.mamba2_prefill(tp, _t(x), CFG_T)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full[:, length:].numpy(), rtol=1e-4, atol=1e-4)


def test_mixer_unaligned_length_and_odd_dims():
    cj, ct = JSSM(d_state=12, headdim=8, chunk_size=8, ngroups=2), SSMConfig(d_state=12, headdim=8, chunk_size=8,
                                                                               ngroups=2)
    jp = JM.init_mamba2_params(jax.random.key(1), 48, cj, jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    x = np.random.default_rng(2).normal(size=(3, 19, 48)).astype(np.float32)
    for got, want in zip(TM.mamba2_prefill(tp, _t(x), ct), JM.mamba2_prefill(jp, jnp.asarray(x), cj)):
        _close(got, want)


def test_left_pad_mask_matches_jax_and_keeps_pads_out(mixer):
    """Row 1 left-padded by 5: its states equal those of the unpadded
    sequence, and the whole output equals JAX's."""
    jp, tp = mixer
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, 14, D_MODEL)).astype(np.float32)
    x[1, :5] = rng.normal(size=(5, D_MODEL)) * 10  # junk in the pad
    mask = np.arange(14)[None, :] >= np.array([0, 5])[:, None]
    out = TM.mamba2_prefill(tp, _t(x), CFG_T, seq_mask=_t(mask))
    ref = JM.mamba2_prefill(jp, jnp.asarray(x), CFG_J, seq_mask=jnp.asarray(mask))
    for got, want in zip(out, ref):
        _close(got, want)
    _, conv_u, ssm_u = TM.mamba2_prefill(tp, _t(x[1:, 5:]), CFG_T)
    _close(out[1][1:], conv_u.numpy())
    _close(out[2][1:], ssm_u.numpy())


def test_dims_and_init_shapes_match_jax(mixer):
    jp, _ = mixer
    assert TM.mamba2_dims(2048, SSMConfig()) == JM.mamba2_dims(2048, JSSM())
    assert TM.mamba2_dims(2048, SSMConfig())["d_in_proj"] == 8512
    gen = torch.Generator().manual_seed(0)
    tp = TM.init_mamba2_params(gen, D_MODEL, CFG_T, torch.float32)
    assert {k: tuple(v.shape) for k, v in tp.items()} == {k: tuple(v.shape) for k, v in jp.items()}
    assert all(tp[k].dtype == torch.float32 for k in ("A_log", "D", "dt_bias"))
    dt = torch.nn.functional.softplus(tp["dt_bias"])
    assert bool(((dt > 0.001 - 1e-6) & (dt < 0.1 + 1e-6)).all())
