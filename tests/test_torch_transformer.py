"""The port's transformer backbone against JAX ``transformer_forward``.

Tiny config (d 64, 2 layers), float32 on the CPU. The same JAX-initialised
params reach the port through ``zonos_tpu_torch.bridge``; hidden states are
compared after a prefill and after each of 6 decode steps, for bf16-layout
and int8 KV caches, dense and int8 weights, with and without left padding.
On the CPU the port's decode step runs the plain versions of K1-K3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zonos_tpu.config import tiny_transformer_config as j_tiny
from zonos_tpu.models import transformer as JT
from zonos_tpu.ops.quant import quantize_int8 as jq8
from zonos_tpu_torch.bridge import params_from_jax
from zonos_tpu_torch.config import tiny_transformer_config
from zonos_tpu_torch.models import transformer as TT

CFG_J = j_tiny().backbone
CFG_T = tiny_transformer_config().backbone


def _params(int8_weights: bool):
    params = JT.init_transformer_params(jax.random.key(0), CFG_J, jnp.float32)
    if int8_weights:
        layers = dict(params["layers"])
        layers["attn"] = {k: jq8(v) for k, v in layers["attn"].items()}
        layers["mlp"] = {k: jq8(v) for k, v in layers["mlp"].items()}
        params = {**params, "layers": layers}
    return params, params_from_jax(jax.tree.map(np.asarray, params))


@pytest.mark.parametrize("kv_int8,int8_weights,pad", [
    (False, False, 0), (False, True, 3), (True, False, 3), (True, True, 0), (True, True, 3),
])
def test_prefill_and_decode_match_jax(kv_int8, int8_weights, pad):
    jp, tp = _params(int8_weights)
    rng = np.random.default_rng(0)
    b, s0, cache_len, steps = 2, 16, 32, 6
    x0 = rng.normal(size=(b, s0, CFG_J.d_model)).astype(np.float32)
    pad_amount = np.full((b,), pad, np.int32)
    pad_amount[1] = 0  # rows with different padding

    jc = JT.KVCache.create(CFG_J, b, cache_len, jnp.float32, quantized=kv_int8)
    tc = TT.KVCache.create(CFG_T, b, cache_len, torch.float32, quantized=kv_int8)
    jh, jc = JT.transformer_forward(jp, CFG_J, jnp.asarray(x0), jc, jnp.int32(0), jnp.asarray(pad_amount), s0)
    th, tc = TT.transformer_forward(tp, CFG_T, torch.from_numpy(x0), tc, 0, torch.from_numpy(pad_amount), s0)
    # float32, only summation order differs: 1e-5 relative to the activations' scale
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-5)

    for t in range(steps):
        xt = rng.normal(size=(b, 1, CFG_J.d_model)).astype(np.float32)
        jh, jc = JT.transformer_forward(jp, CFG_J, jnp.asarray(xt), jc, jnp.int32(s0 + t),
                                        jnp.asarray(pad_amount), cache_len)
        th, tc = TT.transformer_forward(tp, CFG_T, torch.from_numpy(xt), tc, s0 + t,
                                        torch.from_numpy(pad_amount), cache_len)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-5)

    if kv_int8:
        # The in-place cache writes land where JAX's functional ones do. Scales
        # are f32 maxima of K/V that differ in the last bits (summation order),
        # so an int8 value on a rounding tie may land one step apart.
        np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), rtol=0, atol=1)
        np.testing.assert_allclose(tc.v_scale.numpy(), np.asarray(jc.v_scale), rtol=1e-5)
        assert not tc.k.numpy()[:, :, :, s0 + steps:].any()  # slots not yet written stay empty


@pytest.mark.parametrize("mode", ["verify", "gap"])
def test_multi_token_verify_and_gap_decode(mode):
    """A 3-token span attending the whole cache (speculative verify), and a
    decode step with a per-sample dead span and position offsets (slot joins)."""
    jp, tp = _params(True)
    rng = np.random.default_rng(1)
    b, s0, cache_len = 2, 8, 24
    pad = np.zeros((b,), np.int32)
    x0 = rng.normal(size=(b, s0, CFG_J.d_model)).astype(np.float32)
    jc = JT.KVCache.create(CFG_J, b, cache_len, jnp.float32, quantized=True)
    tc = TT.KVCache.create(CFG_T, b, cache_len, torch.float32, quantized=True)
    _, jc = JT.transformer_forward(jp, CFG_J, jnp.asarray(x0), jc, jnp.int32(0), jnp.asarray(pad), s0)
    _, tc = TT.transformer_forward(tp, CFG_T, torch.from_numpy(x0), tc, 0, torch.from_numpy(pad), s0)
    if mode == "verify":
        x = rng.normal(size=(b, 3, CFG_J.d_model)).astype(np.float32)
        jh, _ = JT.transformer_forward(jp, CFG_J, jnp.asarray(x), jc, jnp.int32(s0), jnp.asarray(pad), cache_len)
        th, _ = TT.transformer_forward(tp, CFG_T, torch.from_numpy(x), tc, s0, torch.from_numpy(pad), cache_len)
    else:
        x = rng.normal(size=(b, 1, CFG_J.d_model)).astype(np.float32)
        off, gap = np.array([0, 2], np.int32), np.array([0, 2], np.int32)
        jh, _ = JT.transformer_forward(jp, CFG_J, jnp.asarray(x), jc, jnp.int32(s0 + 2), jnp.asarray(pad),
                                       cache_len, pos_offset=jnp.asarray(off), gap_len=jnp.asarray(gap),
                                       gap_start=s0)
        th, _ = TT.transformer_forward(tp, CFG_T, torch.from_numpy(x), tc, s0 + 2, torch.from_numpy(pad),
                                       cache_len, pos_offset=torch.from_numpy(off),
                                       gap_len=torch.from_numpy(gap), gap_start=s0)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-5)


def test_cache_free_forward_matches_jax():
    jp, tp = _params(False)
    x = np.random.default_rng(2).normal(size=(2, 10, CFG_J.d_model)).astype(np.float32)
    pad = np.array([0, 2], np.int32)
    jh, _ = JT.transformer_forward(jp, CFG_J, jnp.asarray(x), None, jnp.int32(0), jnp.asarray(pad), 10)
    th, _ = TT.transformer_forward(tp, CFG_T, torch.from_numpy(x), None, 0, torch.from_numpy(pad), 10)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-5)
