"""Per-row runtime sampling in the port (``ops/sampling.sample_from_logits_runtime``).

Row i of a runtime call must give the bits the port's static path gives for
row i's own settings, with and without a repetition context; and the
runtime path must agree with JAX's ``sample_from_logits_runtime`` at greedy
and with the same numpy noise injected into both.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zonos_tpu.ops import sampling as JS
from zonos_tpu_torch.ops import sampling as TS

CASES = [
    dict(),
    dict(min_p=0.1),
    dict(top_p=0.9, temperature=0.7),
    dict(linear=0.6, conf=0.2, quad=0.1),
    dict(temperature=0.0),
    dict(repetition_penalty=1.0, top_p=0.5),
    dict(temperature=1.3, min_p=0.05, top_p=0.8, linear=0.4, conf=0.1),
]


def _inputs(b, n_q=9, v=257, window=4, seed=0):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(b, n_q, v)) * 3.0).astype(np.float32)
    noise = rng.exponential(size=(b, n_q, v)).astype(np.float32)
    ctx = rng.integers(0, v, size=(b, n_q, window)).astype(np.int32)
    return logits, noise, ctx


def _static_row(logits, noise, ctx, valid, i, params, top_k, window):
    sp = TS.SamplingParams(top_k=top_k, repetition_penalty_window=window, **params)
    return TS.sample_from_logits(
        torch.from_numpy(logits[i:i + 1]), sp, noise=torch.from_numpy(noise[i:i + 1]),
        generated_tokens=None if ctx is None else torch.from_numpy(ctx[i:i + 1]), generated_valid_len=valid,
    )[0]


@pytest.mark.parametrize("ctx_mode", ["none", "full", "partial"])
@pytest.mark.parametrize("top_k", [0, 17])
def test_runtime_rows_match_static_bit_for_bit(ctx_mode, top_k):
    window = 4
    logits, noise, ctx = _inputs(len(CASES), window=window)
    valid = {"none": None, "full": window, "partial": 2}[ctx_mode]
    if ctx_mode == "none":
        ctx = None
    rt = TS.RuntimeSamplingParams.from_host(
        {k: [TS.SamplingParams(**c).__getattribute__(k) for c in CASES] for k in TS._RUNTIME_FIELDS})
    got = TS.sample_from_logits_runtime(
        torch.from_numpy(logits), rt, top_k=top_k, noise=torch.from_numpy(noise),
        generated_tokens=None if ctx is None else torch.from_numpy(ctx), generated_valid_len=valid,
    )
    for i, c in enumerate(CASES):
        ref = _static_row(logits, noise, ctx, valid, i, c, top_k, window)
        assert torch.equal(got[i], ref), (i, c)


def test_from_static_round_trip_and_set_row():
    sp = TS.SamplingParams(temperature=0.8, top_p=0.7, min_p=0.05, linear=0.3, conf=0.2, quad=0.1,
                           repetition_penalty=2.0)
    rt = TS.RuntimeSamplingParams.from_static(sp, 3)
    for k in TS._RUNTIME_FIELDS:
        assert rt.host[k].shape == (3,) and rt.host[k].dtype == np.float32
        np.testing.assert_array_equal(getattr(rt, k).numpy(), np.float32(getattr(sp, k)))
        np.testing.assert_array_equal(getattr(rt, k).numpy(), rt.host[k])
    jrt = JS.RuntimeSamplingParams.from_static(JS.SamplingParams(**{f: getattr(sp, f) for f in TS._RUNTIME_FIELDS}), 3)
    for k in TS._RUNTIME_FIELDS:
        np.testing.assert_array_equal(getattr(rt, k).numpy(), np.asarray(getattr(jrt, k)))
    greedy = TS.RuntimeSamplingParams.from_static(TS.SamplingParams(temperature=0.0, top_p=0.0), 1)
    rt2 = rt.set_row(1, greedy)
    assert rt2.host["temperature"].tolist() == [np.float32(0.8), 0.0, np.float32(0.8)]
    assert rt.host["temperature"][1] == np.float32(0.8)  # the original is unchanged
    np.testing.assert_array_equal(rt2.top_p.numpy(), rt2.host["top_p"])
    assert rt2.any("top_p") and not greedy.any("top_p")


def _jax_rt(cases):
    f = lambda k: jnp.asarray([getattr(JS.SamplingParams(**c), k) for c in cases], jnp.float32)  # noqa: E731
    return JS.RuntimeSamplingParams(**{k: f(k) for k in TS._RUNTIME_FIELDS})


@pytest.mark.parametrize("with_ctx", [False, True])
def test_runtime_matches_jax_greedy(with_ctx):
    cases = [dict(temperature=0.0), dict(temperature=0.0, repetition_penalty=1.0),
             dict(temperature=0.0, repetition_penalty=2.5)]
    logits, _noise, ctx = _inputs(len(cases), seed=3)
    import jax

    keys = jax.vmap(lambda s: jax.random.fold_in(jax.random.key(0), s))(jnp.arange(len(cases)))
    ref = JS.sample_from_logits_runtime(
        keys, jnp.asarray(logits), _jax_rt(cases), generated_tokens=jnp.asarray(ctx) if with_ctx else None,
        generated_valid_len=jnp.int32(3) if with_ctx else None,
    )
    rt = TS.RuntimeSamplingParams.from_host({k: [getattr(TS.SamplingParams(**c), k) for c in cases]
                                             for k in TS._RUNTIME_FIELDS})
    gens = [torch.Generator().manual_seed(i) for i in range(len(cases))]
    got = TS.sample_from_logits_runtime(
        torch.from_numpy(logits), rt, generators=gens,
        generated_tokens=torch.from_numpy(ctx) if with_ctx else None, generated_valid_len=3 if with_ctx else None,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("top_k", [0, 17])
def test_runtime_matches_jax_with_injected_noise(monkeypatch, top_k):
    logits, noise, ctx = _inputs(len(CASES), seed=5)
    # JAX draws its race noise in gumbel_sample; the same numpy noise goes in.
    monkeypatch.setattr(JS, "gumbel_sample", lambda key, probs: jnp.argmax(probs / jnp.asarray(noise), axis=-1))
    import jax

    keys = jax.vmap(lambda s: jax.random.fold_in(jax.random.key(0), s))(jnp.arange(len(CASES)))
    ref = JS.sample_from_logits_runtime(keys, jnp.asarray(logits), _jax_rt(CASES), top_k=top_k,
                                        generated_tokens=jnp.asarray(ctx), generated_valid_len=jnp.int32(4))
    rt = TS.RuntimeSamplingParams.from_host({k: [getattr(TS.SamplingParams(**c), k) for c in CASES]
                                             for k in TS._RUNTIME_FIELDS})
    got = TS.sample_from_logits_runtime(torch.from_numpy(logits), rt, top_k=top_k, noise=torch.from_numpy(noise),
                                        generated_tokens=torch.from_numpy(ctx), generated_valid_len=4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
