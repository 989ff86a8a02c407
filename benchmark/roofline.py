"""Peaks of one NVIDIA H100 (SXM, NVIDIA's data sheet, dense) and the
operations and bytes of the kernels and of a whole decode step, from shapes.

A kernel's least time is the larger of its bytes at the memory bandwidth and
its operations at the bf16 tensor peak. The bytes of a weight-streaming GEMV
are the int8 weight and its float32 scales read once, x (bf16) read once and
y (float32) written once; those of K3 (the fused int8 MLP) are fc1's and
fc2's weights and scales, x and y.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

# Device kernels of the port's hand-written K1-K3 (the names the profiler shows).
K1_K3 = ("int8_gemv_cluster", "mlp_fc1_gate")


def least_s(flops: float, nbytes: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS)


def k1(b: int, k: int, n: int) -> tuple[float, float]:
    """(operations, bytes) of one K1 launch: x [b, k] bf16 @ int8 [k, n] → f32 [b, n]."""
    return 2.0 * b * k * n, k * n + 4 * n + 2 * b * k + 4 * b * n


def k3(b: int, d: int, f: int) -> tuple[float, float]:
    """(operations, bytes) of one K3 call (fc1 and the gate, then fc2): x [b, d]."""
    return 2.0 * b * (d * 2 * f + f * d), d * 2 * f + 4 * 2 * f + f * d + 4 * d + 2 * b * d + 4 * b * d


def step_calls(cfg: dict, rows: int) -> list[tuple[str, tuple]]:
    """The K1 and K3 calls of one decode step at ``rows`` rows, in the order of
    the layers: ("k1", (b, k, n)) and ("k3", (b, d, f))."""
    bb = cfg["backbone"]
    d = bb["d_model"]
    a = bb["attn_cfg"]
    hq, hkv = a["num_heads"], a["num_heads_kv"]
    dh = a.get("head_dim") or d // hq
    ssm = bb.get("ssm_cfg")
    attn = set(bb["attn_layer_idx"])
    calls = []
    for i in range(bb["n_layer"]):
        if not ssm or i in attn:
            calls += [("k1", (rows, d, (hq + 2 * hkv) * dh)), ("k1", (rows, hq * dh, d)),
                      ("k3", (rows, d, bb["attn_mlp_d_intermediate"]))]
        else:
            d_inner = ssm["expand"] * d
            nheads = d_inner // ssm["headdim"]
            gn = ssm["ngroups"] * ssm["d_state"]
            calls += [("k1", (rows, d, 2 * d_inner + 2 * gn + nheads)), ("k1", (rows, d_inner, d))]
            if bb["d_intermediate"]:
                calls.append(("k3", (rows, d, bb["d_intermediate"])))
    calls.append(("k1", (rows, d, cfg["codebook_dimension"] * (cfg["eos_token_id"] + 1))))
    return calls


def kernels_least_s(cfg: dict, rows: int) -> float:
    """Σ of the least times of one step's K1 and K3 launches."""
    total = 0.0
    for kind, shape in step_calls(cfg, rows):
        total += least_s(*(k1(*shape) if kind == "k1" else k3(*shape)))
    return total


def heads_least_s(cfg: dict, rows: int) -> float:
    """The least time of one K1 launch over the heads (a prefill's first sample)."""
    d = cfg["backbone"]["d_model"]
    return least_s(*k1(rows, d, cfg["codebook_dimension"] * (cfg["eos_token_id"] + 1)))


def step_least_s(cfg: dict, rows: int) -> float:
    """The least time of a whole decode step: every int8 weight and its scales
    read once (the matmuls of ``step_calls``), the activations in and out,
    against the step's matmul operations at the bf16 peak. The KV cache the
    step attends and the small per-layer vectors are left out, so the bound is
    low and the share it gives is a lower bound."""
    flops = nbytes = 0.0
    for kind, shape in step_calls(cfg, rows):
        f, b = k1(*shape) if kind == "k1" else k3(*shape)
        flops += f
        nbytes += b
    return least_s(flops, nbytes)
