"""Mamba2 (SSD) mixer: chunked prefill and single-token step (port of
``zonos_tpu/ops/mamba2.py``).

Per head h, with Δ the softplus'd timestep:

    state_t = exp(Δ_t·A_h) · state_{t-1} + Δ_t · B_t ⊗ x_t
    y_t = C_t · state_t + D_h · x_t

The prefill uses the chunked dual form: attention-like products inside each
chunk, and a loop over chunks (JAX's ``lax.scan``) that carries the state
from one chunk to the next. The decode step is the rank-1 state update. The
depthwise causal conv1d before the SSD carries its last K-1 inputs as state.
Everything here is plain PyTorch, as the JAX package leaves it to XLA; the
in_proj and out_proj go through ``ops.quant.qeinsum``, so that a decode row
reaches K1 (int8) or K4 (int4).

Under tensor parallelism (``mesh`` with tp > 1; JAX's layout of
``parallel/mesh.hybrid_param_specs``) each rank holds a contiguous 1/tp of
in_proj's packed output columns and of out_proj's rows. The projected
activations are gathered over tp, the conv, the scan and the gated norm run
on them whole and replicated, and each rank's slice of y goes through its
out_proj rows, reduced over tp.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from zonos_tpu_torch.config import SSMConfig
from zonos_tpu_torch.ops.quant import qeinsum
from zonos_tpu_torch.parallel.comm import copy_to_tp, gather_from_tp, reduce_from_tp, scatter_to_tp


# ---------------------------------------------------------------------------
# Causal depthwise conv1d
# ---------------------------------------------------------------------------

def causal_conv1d_prefill(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, conv_state: torch.Tensor):
    """x [B, L, C], taps w [K, C], bias b [C], left context conv_state [B, K-1, C]
    → (silu(conv), new conv_state [B, K-1, C])."""
    k, length = w.shape[0], x.shape[1]
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)  # [B, L+K-1, C]
    y = sum(xp[:, i:i + length] * w[i].to(x.dtype) for i in range(k))
    y = y + b.to(x.dtype)
    return F.silu(y), xp[:, -(k - 1):]


def causal_conv1d_step(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, conv_state: torch.Tensor):
    """One position: x [B, C] → (silu(conv) [B, C], new conv_state [B, K-1, C])."""
    window = torch.cat([conv_state.to(x.dtype), x[:, None, :]], dim=1)  # [B, K, C]
    y = torch.einsum("bkc,kc->bc", window, w.to(x.dtype)) + b.to(x.dtype)
    return F.silu(y), window[:, 1:]


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------

def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B_: torch.Tensor, C_: torch.Tensor,
                chunk_size: int, init_state: torch.Tensor | None = None):
    """Chunked SSD scan: x [B, L, H, P], dt [B, L, H] (softplus'd), A [H] (< 0),
    B_/C_ [B, L, G, N], init_state [B, H, N, P] or None
    → (y [B, L, H, P], final state [B, H, N, P]), in f32 (f64 stays f64).

    L need not be a multiple of ``chunk_size``: the tail chunk is padded with
    dt = 0, which neither decays the state nor adds to it, and the padded
    outputs are dropped.
    """
    b, length, h, p = x.shape
    g, n = B_.shape[2], B_.shape[3]
    q = chunk_size
    pad = (-length) % q
    if pad:
        x, B_, C_ = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, B_, C_))
        dt = F.pad(dt, (0, 0, 0, pad))
    nc = (length + pad) // q
    rep = h // g
    f32 = torch.promote_types(x.dtype, torch.float32)
    xc = x.reshape(b, nc, q, h, p).to(f32)
    dtc = dt.reshape(b, nc, q, h).to(f32)
    Bh = torch.repeat_interleave(B_.reshape(b, nc, q, g, n).to(f32), rep, dim=3)  # [B, NC, Q, H, N]
    Ch = torch.repeat_interleave(C_.reshape(b, nc, q, g, n).to(f32), rep, dim=3)

    dA = dtc * A.to(f32)[None, None, None, :]  # [B, NC, Q, H], <= 0
    cum = torch.cumsum(dA, dim=2)  # inclusive, within each chunk
    total = cum[:, :, -1, :]  # [B, NC, H]
    x_dt = xc * dtc[..., None]

    # Inside a chunk (the dual, attention-like form): decay(s → t) = exp(cum_t - cum_s), s <= t.
    # Masked before the exp: above the diagonal cum_t - cum_s > 0 can overflow
    # exp to inf, whose gradient through a select after the exp is 0 · inf = NaN.
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B, NC, T, S, H]
    tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    l_mat = torch.exp(torch.where(tri[None, None, :, :, None], seg, torch.full((), -torch.inf, dtype=f32,
                                                                               device=x.device)))
    scores = torch.einsum("bcthn,bcshn->bctsh", Ch, Bh) * l_mat
    y_diag = torch.einsum("bctsh,bcshp->bcthp", scores, x_dt)

    # Each chunk's own state: sum_s exp(total - cum_s) · B_s ⊗ (dt_s x_s).
    decay_to_end = torch.exp(total[:, :, None, :] - cum)  # [B, NC, Q, H]
    states = torch.einsum("bcshn,bcsh,bcshp->bchnp", Bh, decay_to_end, x_dt)

    # Across chunks: the state entering each chunk.
    carry = torch.zeros((b, h, n, p), dtype=f32, device=x.device) if init_state is None else init_state.to(f32)
    entering = []
    for c in range(nc):
        entering.append(carry)
        carry = carry * torch.exp(total[:, c])[:, :, None, None] + states[:, c]
    prev_states = torch.stack(entering, dim=1)  # [B, NC, H, N, P]

    y_off = torch.einsum("bcthn,bchnp->bcthp", Ch, prev_states) * torch.exp(cum)[..., None]
    y = (y_diag + y_off).reshape(b, nc * q, h, p)[:, :length]
    return y, carry


def ssd_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B_: torch.Tensor, C_: torch.Tensor,
             state: torch.Tensor):
    """One position: x [B, H, P], dt [B, H], B_/C_ [B, G, N], state [B, H, N, P]
    → (y [B, H, P], new state), in f32 (whatever the state's dtype)."""
    rep = x.shape[1] // B_.shape[1]
    f32 = torch.promote_types(x.dtype, torch.float32)
    xf, dtf = x.to(f32), dt.to(f32)
    Bh = torch.repeat_interleave(B_.to(f32), rep, dim=1)  # [B, H, N]
    Ch = torch.repeat_interleave(C_.to(f32), rep, dim=1)
    decay = torch.exp(dtf * A.to(f32)[None, :])  # [B, H]
    update = torch.einsum("bhn,bhp->bhnp", Bh, xf * dtf[..., None])
    new_state = state * decay[..., None, None] + update
    return torch.einsum("bhn,bhnp->bhp", Ch, new_state), new_state


# ---------------------------------------------------------------------------
# The mixer: in_proj → conv → SSD → gated norm → out_proj
# ---------------------------------------------------------------------------

def mamba2_dims(d_model: int, cfg: SSMConfig) -> dict:
    d_inner = cfg.expand * d_model
    nheads = d_inner // cfg.headdim
    conv_dim = d_inner + 2 * cfg.ngroups * cfg.d_state
    return {
        "d_inner": d_inner,
        "nheads": nheads,
        "conv_dim": conv_dim,
        "d_in_proj": 2 * d_inner + 2 * cfg.ngroups * cfg.d_state + nheads,
    }


def _split_proj(zxbcdt: torch.Tensor, d_model: int, cfg: SSMConfig):
    """in_proj's output → (z, xBC before the conv, raw dt)."""
    dims = mamba2_dims(d_model, cfg)
    return torch.split(zxbcdt, [dims["d_inner"], dims["conv_dim"], dims["nheads"]], dim=-1)


def _clamp_dt(dt: torch.Tensor, cfg: SSMConfig) -> torch.Tensor:
    """mamba-ssm's ``dt_limit`` clamp (the default (0, inf) leaves dt as it is)."""
    lo, hi = cfg.dt_limit
    if lo == 0.0 and hi == float("inf"):
        return dt
    return torch.clamp(dt, min=lo, max=None if hi == float("inf") else hi)


def _gated_rms_norm(y: torch.Tensor, z: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """mamba-ssm's RMSNormGated(norm_before_gate=False): rmsnorm(y · silu(z)) · w."""
    yf = (y * F.silu(z)).float()
    ms = yf.square().mean(dim=-1, keepdim=True)
    return (yf * torch.rsqrt(ms + eps) * weight.float()).to(y.dtype)


def _dt(dt_raw: torch.Tensor, p: dict, cfg: SSMConfig) -> torch.Tensor:
    return _clamp_dt(F.softplus(dt_raw.float() + p["dt_bias"].float()), cfg)


def _in_proj(eq: str, x: torch.Tensor, w, mesh) -> torch.Tensor:
    """in_proj: over tp, this rank's columns, gathered to the whole packed axis."""
    return gather_from_tp(qeinsum(eq, copy_to_tp(x, mesh), w), mesh)


def _out_proj(eq: str, y: torch.Tensor, w, mesh) -> torch.Tensor:
    """out_proj: over tp, this rank's slice of y through its rows, reduced."""
    return reduce_from_tp(qeinsum(eq, scatter_to_tp(y, mesh), w, out_dtype=torch.float32), mesh).to(y.dtype)


def mamba2_prefill(p: dict, x: torch.Tensor, cfg: SSMConfig, seq_mask: torch.Tensor | None = None, mesh=None):
    """The mixer over a whole sequence x [B, L, D], from zero states
    → (y [B, L, D], conv_state [B, K-1, conv_dim], ssm_state [B, H, N, P] f32).

    ``seq_mask`` [B, L] (True where valid) keeps left-pad positions out of
    both states: their conv inputs are zeroed and their dt is 0.
    """
    b, length, d_model = x.shape
    dims = mamba2_dims(d_model, cfg)
    d_inner, nheads, gn = dims["d_inner"], dims["nheads"], cfg.ngroups * cfg.d_state

    z, xbc, dt_raw = _split_proj(_in_proj("bld,de->ble", x, p["in_proj"], mesh), d_model, cfg)
    if seq_mask is not None:
        xbc = xbc * seq_mask[..., None].to(xbc.dtype)
    conv0 = torch.zeros((b, cfg.d_conv - 1, dims["conv_dim"]), dtype=x.dtype, device=x.device)
    xbc, conv_state = causal_conv1d_prefill(xbc, p["conv_w"], p["conv_b"], conv0)
    xs, B_, C_ = torch.split(xbc, [d_inner, gn, gn], dim=-1)
    xs = xs.reshape(b, length, nheads, cfg.headdim)

    dt = _dt(dt_raw, p, cfg)
    if seq_mask is not None:  # after the clamp: padded positions get dt == 0 exactly
        dt = dt * seq_mask[..., None].to(dt.dtype)
    A = -torch.exp(p["A_log"].float())
    y, ssm_state = ssd_chunked(xs, dt, A, B_.reshape(b, length, cfg.ngroups, cfg.d_state),
                               C_.reshape(b, length, cfg.ngroups, cfg.d_state), cfg.chunk_size)
    y = y + xs * p["D"].float()[None, None, :, None]
    y = _gated_rms_norm(y.reshape(b, length, d_inner).to(x.dtype), z, p["norm_w"], 1e-5)
    return _out_proj("ble,ed->bld", y, p["out_proj"], mesh), conv_state, ssm_state.float()


def mamba2_step(p: dict, x: torch.Tensor, cfg: SSMConfig, conv_state: torch.Tensor, ssm_state: torch.Tensor,
                mesh=None):
    """One token x [B, 1, D] → (y [B, 1, D], new conv_state, new ssm_state (f32)).
    The projections see x as [B, 1, D], the shape that takes K1 or K4."""
    b, _, d_model = x.shape
    dims = mamba2_dims(d_model, cfg)
    d_inner, nheads, gn = dims["d_inner"], dims["nheads"], cfg.ngroups * cfg.d_state

    z, xbc, dt_raw = _split_proj(_in_proj("bsd,de->bse", x, p["in_proj"], mesh)[:, 0], d_model, cfg)
    xbc, conv_state = causal_conv1d_step(xbc, p["conv_w"], p["conv_b"], conv_state)
    xs, B_, C_ = torch.split(xbc, [d_inner, gn, gn], dim=-1)
    xs = xs.reshape(b, nheads, cfg.headdim)
    A = -torch.exp(p["A_log"].float())
    y, ssm_state = ssd_step(xs, _dt(dt_raw, p, cfg), A, B_.reshape(b, cfg.ngroups, cfg.d_state),
                            C_.reshape(b, cfg.ngroups, cfg.d_state), ssm_state)
    y = y + xs.float() * p["D"].float()[None, :, None]
    y = _gated_rms_norm(y.reshape(b, 1, d_inner).to(x.dtype), z[:, None], p["norm_w"], 1e-5)
    return _out_proj("bse,ed->bsd", y, p["out_proj"], mesh), conv_state, ssm_state


def init_mamba2_params(generator: torch.Generator, d_model: int, cfg: SSMConfig, dtype=torch.bfloat16,
                       device=None) -> dict:
    """Random-init mixer params (the JAX package's distributions): in_proj and
    out_proj normal / sqrt(fan_in), conv taps normal · 0.2, dt drawn
    log-uniform in [0.001, 0.1] and stored as its inverse softplus, A_log =
    log(linspace(1, 16)), D = 1. The SSD scalars stay f32."""
    dims = mamba2_dims(d_model, cfg)

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32, device=device)

    in_proj = normal(d_model, dims["d_in_proj"]) / math.sqrt(d_model)
    conv_w = normal(cfg.d_conv, dims["conv_dim"]) * 0.2
    out_proj = normal(dims["d_inner"], d_model) / math.sqrt(dims["d_inner"])
    u = torch.rand((dims["nheads"],), generator=generator, dtype=torch.float32, device=device)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": in_proj.to(dtype),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((dims["conv_dim"],), dtype=dtype, device=device),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),
        "A_log": torch.log(torch.linspace(1.0, 16.0, dims["nheads"], **f32)),
        "D": torch.ones((dims["nheads"],), **f32),
        "norm_w": torch.ones((dims["d_inner"],), dtype=dtype, device=device),
        "out_proj": out_proj.to(dtype),
    }
