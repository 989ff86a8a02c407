"""Share of the traced slice's device kernel time spent outside the
hand-written kernels (K1 and K3's ``int8_gemv_cluster`` and ``mlp_fc1_gate``,
K2's ``attn_cluster``) and the codec's and speaker tower's cuDNN convolutions
(``convolve`` in the name), in %. The rest is the glue: in the Granite cell
mostly the Mamba-2 decode step's torch ops (the conv as an einsum, the SSD
state update, the gated norm), the norms, residuals and sampling."""

KNOWN = ("int8_gemv_cluster", "mlp_fc1_gate", "attn_cluster", "convolve")


def read(ctx):
    total = sum(e - s for _, s, e in ctx.kernels) / 1e6
    if not total:
        return None
    known, _ = ctx.kernel_time_s(KNOWN)
    return 100.0 * (total - known) / total
