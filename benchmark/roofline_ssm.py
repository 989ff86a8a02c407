"""The recurrent state of a hybrid's decode step, and the whole step's least
time with it.

``roofline.step_calls`` counts a step's int8 weights and scales (the Mamba-2
layers' in_proj and out_proj and every MLP included). A Mamba-2 layer's
decode step also reads each row's SSD state [H, N, P] and conv state
[K-1, conv_dim] once and writes them once; this module adds that traffic, at
2 bytes an element (bf16, the dtype the port holds them in for a bf16 model).
"""

from __future__ import annotations

from benchmark import roofline

STATE_ELEMENT_BYTES = 2


def state_bytes_per_row(cfg: dict) -> int:
    """Bytes of one row's SSD and conv states over every Mamba-2 layer."""
    bb = cfg["backbone"]
    s = bb.get("ssm_cfg")
    if not s:
        return 0
    d_inner = s["expand"] * bb["d_model"]
    conv_dim = d_inner + 2 * s["ngroups"] * s["d_state"]
    per_layer = (d_inner // s["headdim"]) * s["d_state"] * s["headdim"] + (s["d_conv"] - 1) * conv_dim
    return (bb["n_layer"] - len(bb["attn_layer_idx"])) * per_layer * STATE_ELEMENT_BYTES


def step_least_s(cfg: dict, rows: int) -> float:
    """The least time of a whole decode step at ``rows`` rows: the int8
    weights, scales and activations of ``roofline.step_calls`` and the
    recurrent state read and written once, against the step's matmul
    operations at the bf16 peak. The KV cache and the small per-layer vectors
    are left out, so the share it gives is a lower bound."""
    flops = nbytes = 0.0
    for kind, shape in roofline.step_calls(cfg, rows):
        f, b = roofline.k1(*shape) if kind == "k1" else roofline.k3(*shape)
        flops += f
        nbytes += b
    return roofline.least_s(flops, nbytes + 2 * rows * state_bytes_per_row(cfg))
