"""The PyTorch port's ops (zonos_tpu_torch.ops) against the JAX package's.

The same numpy inputs from a seeded generator go through both; everything
runs at float32 on the CPU. Tolerances: 1e-5 relative for float32 math that
only sums in another order; exact where the op is a selection or integer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zonos_tpu.ops import attention as JA
from zonos_tpu.ops import delay_pattern as JD
from zonos_tpu.ops import norms as JN
from zonos_tpu.ops import quant as JQ
from zonos_tpu.ops import rope as JR
from zonos_tpu.ops import sampling as JS
from zonos_tpu_torch.ops import attention as TA
from zonos_tpu_torch.ops import delay_pattern as TD
from zonos_tpu_torch.ops import norms as TN
from zonos_tpu_torch.ops import quant as TQ
from zonos_tpu_torch.ops import rope as TR
from zonos_tpu_torch.ops import sampling as TS

RTOL = 1e-5  # float32, summation order only


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, rtol=RTOL, atol=None):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    atol = rtol * float(np.abs(ref).max()) if atol is None else atol
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)


@pytest.mark.parametrize("shape", [(2, 5, 64), (3, 128)])
def test_layer_norm(shape):
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32) * 3 + 1
    s = rng.normal(size=shape[-1:]).astype(np.float32)
    b = rng.normal(size=shape[-1:]).astype(np.float32)
    _close(TN.layer_norm(_t(x), _t(s), _t(b)), JN.layer_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b)))


@pytest.mark.parametrize("batched_positions", [False, True])
def test_rope_paired_dims(batched_positions):
    rng = np.random.default_rng(1)
    b, s, h, dh = 2, 7, 3, 16
    x = rng.normal(size=(b, s, h, dh)).astype(np.float32)
    pos = np.arange(s) + 5
    if batched_positions:
        pos = pos[None, :] - np.array([[0], [3]])
    jf = JR.rope_rows(jnp.asarray(pos), dh)
    tf = TR.rope_rows(_t(pos), dh)
    _close(tf, jf)
    _close(TR.apply_rope(_t(x), tf), JR.apply_rope(jnp.asarray(x), jf))


@pytest.mark.parametrize("host", [False, True])
def test_delay_pattern(host):
    codes = np.random.default_rng(2).integers(0, 1024, size=(2, 9, 12)).astype(np.int32)
    ref = np.asarray(JD.apply_delay_pattern(jnp.asarray(codes), 1025))
    if host:
        got = TD.apply_delay_pattern_np(codes, 1025)
        back = TD.revert_delay_pattern_np(got)
    else:
        got = TD.apply_delay_pattern(_t(codes), 1025).numpy()
        back = TD.revert_delay_pattern(_t(got)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(back, codes)
    np.testing.assert_array_equal(back, np.asarray(JD.revert_delay_pattern(jnp.asarray(ref))))


@pytest.mark.parametrize("shape", [(64, 96), (2, 64, 48)])
def test_quantize_int8_bit_exact(shape):
    w = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    w[..., 5] = 0.0  # an all-zero output channel takes scale 1
    ref = JQ.quantize_int8(jnp.asarray(w))
    got = TQ.quantize_int8(_t(w))
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(ref["q"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(ref["s"]))
    deq = np.asarray(JQ.dequantize(ref).astype(jnp.float32))
    np.testing.assert_array_equal(TQ.dequantize(got).float().numpy(), deq)  # both round to bf16


@pytest.mark.parametrize("b,s,quantized", [(2, 1, True), (2, 9, True), (3, 4, False)])
def test_qeinsum_fp32(b, s, quantized):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(b, s, 64)).astype(np.float32)
    w = rng.normal(size=(64, 80)).astype(np.float32) / 8
    jw = JQ.quantize_int8(jnp.asarray(w)) if quantized else jnp.asarray(w)
    tw = {"q": _t(jw["q"]), "s": _t(jw["s"])} if quantized else _t(w)
    _close(TQ.qeinsum("bsd,de->bse", _t(x), tw), JQ.qeinsum("bsd,de->bse", jnp.asarray(x), jw))


@pytest.mark.parametrize("b,s", [(2, 1), (2, 9)])  # decode shape (K4's plain version) and prefill
def test_qeinsum_int4_fp32(b, s):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(b, s, 128)).astype(np.float32)
    jw = JQ.quantize_int4(jnp.asarray(rng.normal(size=(128, 80)).astype(np.float32) / 8))
    tw = {"q4": _t(jw["q4"]), "s4": _t(jw["s4"])}
    _close(TQ.qeinsum("bsd,de->bse", _t(x), tw), JQ.qeinsum("bsd,de->bse", jnp.asarray(x), jw))


def test_gqa_attention_causal_prefix():
    rng = np.random.default_rng(5)
    b, s, hq, hkv, dh = 2, 9, 4, 2, 16
    q, k, v = (rng.normal(size=(b, s, h, dh)).astype(np.float32) for h in (hq, hkv, hkv))
    pad = np.array([0, 3], np.int32)
    jm = JA.causal_prefix_mask(s, jnp.asarray(pad))
    tm = TA.causal_prefix_mask(s, _t(pad))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    ref = JA.gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm)
    _close(TA.gqa_attention(_t(q), _t(k), _t(v), tm), ref)


@pytest.mark.parametrize("b", [2, 16])  # 16 takes the int8 x int8 q.k branch in both
def test_gqa_attention_quantized(b):
    from zonos_tpu.models.transformer import _kv_quantize

    rng = np.random.default_rng(6)
    s, hq, hkv, dh = 24, 4, 2, 32
    q = rng.normal(size=(b, 1, hq, dh)).astype(np.float32)
    kq, ks = _kv_quantize(jnp.asarray(rng.normal(size=(b, s, hkv, dh)).astype(np.float32)))
    vq, vs = _kv_quantize(jnp.asarray(rng.normal(size=(b, s, hkv, dh)).astype(np.float32)))
    kq, vq = jnp.swapaxes(kq, 1, 2), jnp.swapaxes(vq, 1, 2)
    ks, vs = jnp.swapaxes(ks, 1, 2), jnp.swapaxes(vs, 1, 2)
    pad = rng.integers(0, 4, size=(b,)).astype(np.int32)
    jm = JA.decode_mask(s, jnp.asarray(pad), jnp.int32(19))
    ref = JA.gqa_attention_quantized(jnp.asarray(q), kq, ks, vq, vs, jm)
    tm = TA.decode_mask(s, _t(pad), 19)
    got = TA.gqa_attention_quantized(_t(q), _t(kq), _t(ks), _t(vq), _t(vs), tm)
    _close(got, ref)


@pytest.mark.parametrize("gap", [None, [0, 5, 2]])
def test_decode_mask(gap):
    pad = np.array([0, 2, 7], np.int32)
    gl = None if gap is None else np.array(gap, np.int32)
    ref = JA.decode_mask(40, jnp.asarray(pad), jnp.int32(30), gap_start=16,
                         gap_len=None if gl is None else jnp.asarray(gl))
    got = TA.decode_mask(40, _t(pad), 30, gap_start=16, gap_len=None if gl is None else _t(gl))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------

def _probs(seed=7, shape=(3, 9, 40)):
    logits = np.random.default_rng(seed).normal(size=shape).astype(np.float32) * 2
    return logits, np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))


@pytest.mark.parametrize("name,jfn,tfn", [
    ("top_k", lambda p: JS.apply_top_k(p, 5), lambda p: TS.apply_top_k(p, 5)),
    ("top_p", lambda p: JS.apply_top_p(p, 0.7), lambda p: TS.apply_top_p(p, 0.7)),
    ("min_p", lambda p: JS.apply_min_p(p, 0.1), lambda p: TS.apply_min_p(p, 0.1)),
    ("unified", lambda p: JS.apply_unified(p, 0.5, 0.2, 0.1), lambda p: TS.apply_unified(p, 0.5, 0.2, 0.1)),
])
def test_sampling_filters(name, jfn, tfn):
    _, probs = _probs()
    ref = np.asarray(jfn(jnp.asarray(probs)))
    got = tfn(_t(probs)).numpy()
    np.testing.assert_array_equal(got == 0, ref == 0)  # the same tokens survive
    _close(got, ref, atol=1e-6)


def test_repetition_penalty():
    logits, _ = _probs(8)
    toks = np.random.default_rng(9).integers(-1, 40, size=(3, 9, 6)).astype(np.int32)
    ref = JS.apply_repetition_penalty(jnp.asarray(logits), jnp.asarray(toks), 3.0, 4, valid_len=jnp.int32(3))
    got = TS.apply_repetition_penalty(_t(logits), _t(toks), 3.0, 4, valid_len=3)
    _close(got, ref)


@pytest.mark.parametrize("params", [
    dict(min_p=0.1),
    dict(top_p=0.8, top_k=7, temperature=0.7),
    dict(linear=0.6, conf=0.3, quad=0.1, min_p=0.05),
])
def test_draw_with_injected_noise(params):
    logits, _ = _probs(10)
    noise = np.random.default_rng(11).exponential(size=logits.shape).astype(np.float32)
    sp = dict(repetition_penalty=1.0, **params)
    got = TS.sample_from_logits(_t(logits), TS.SamplingParams(**sp), noise=_t(noise)).numpy()
    # JAX's filtered distribution, raced against the same noise
    jp = JS.SamplingParams(**sp)
    probs = jax.nn.softmax(jnp.asarray(logits) / jp.temperature, axis=-1)
    if jp.linear > 0:
        probs = JS.apply_unified(probs, jp.linear, jp.conf, jp.quad)
    if jp.top_p > 0:
        probs = JS.apply_top_p(probs, jp.top_p)
    if jp.top_k > 0:
        probs = JS.apply_top_k(probs, jp.top_k)
    if jp.min_p > 0:
        probs = JS.apply_min_p(probs, jp.min_p)
    ref = np.argmax(np.asarray(probs) / noise, axis=-1)
    np.testing.assert_array_equal(got, ref)


def test_greedy_and_per_row_generators():
    logits, _ = _probs(12)
    greedy = TS.sample_from_logits(_t(logits), TS.SamplingParams(temperature=0.0))
    np.testing.assert_array_equal(greedy.numpy(), np.argmax(logits, -1))
    gens = [torch.Generator().manual_seed(s) for s in (1, 2, 3)]
    solo = torch.Generator().manual_seed(2)
    both = TS.exponential_noise((3, 9, 40), gens, "cpu")
    np.testing.assert_array_equal(both[1].numpy(), TS.exponential_noise((1, 9, 40), [solo], "cpu")[0].numpy())
