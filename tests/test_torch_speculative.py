"""The port's speculative decode (``zonos_tpu_torch/runtime/speculative.py``),
mirroring ``tests/test_speculative.py`` and held against the JAX package's.

Tiny transformer, float32 on the CPU. With greedy sampling the speculative
output equals the sequential greedy output token for token (any draft), at
the audio-bucket boundary too; it equals JAX's ``generate_speculative`` with
int8 weights and the int8 KV cache, passes and acceptance included; sampled
runs report consistent stats; the repetition penalty and the hybrid are
refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zonos_tpu.conditioning.cond_dict import make_cond_dict as j_make_cond_dict
from zonos_tpu.config import tiny_transformer_config as j_tiny
from zonos_tpu.models.zonos import Zonos as JZonos
from zonos_tpu.ops.sampling import SamplingParams as JSP
from zonos_tpu.runtime import speculative as JS
from zonos_tpu_torch.bridge import params_from_jax
from zonos_tpu_torch.conditioning.cond_dict import make_cond_dict
from zonos_tpu_torch.config import tiny_hybrid_config, tiny_transformer_config
from zonos_tpu_torch.models.zonos import Zonos
from zonos_tpu_torch.ops.sampling import SamplingParams
from zonos_tpu_torch.runtime import generate as G
from zonos_tpu_torch.runtime.speculative import generate_speculative

GREEDY = SamplingParams(top_k=1, min_p=0.0, repetition_penalty=1.0)
KW = dict(cfg_scale=2.0, dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def model():
    return Zonos.from_config(tiny_transformer_config(), seed=0, dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def cond(model):
    cd = make_cond_dict(text="speculate about this", speaker=np.zeros((1, 1, 128), np.float32))
    return model.prepare_conditioning(cd).numpy()


def test_greedy_speculative_matches_sequential(model, cond):
    seq = G.generate(model.params, model.config, cond, max_new_tokens=40, sampling_params=GREEDY, seed=3, **KW)
    spec, stats = generate_speculative(model.params, model.config, cond, max_new_tokens=40,
                                       sampling_params=GREEDY, seed=3, return_stats=True, **KW)
    # an accepted final pass may overshoot the budget by one frame
    n = seq.shape[-1]
    assert abs(spec.shape[-1] - n) <= 1
    np.testing.assert_array_equal(spec[..., :n][..., :spec.shape[-1]], seq[..., :spec.shape[-1]])
    assert stats["passes"] >= 1
    assert stats["frames"] == stats["passes"] + stats["accepted"]
    assert 0.0 <= stats["acceptance"] <= 1.0


def test_self_draft_never_takes_more_passes_than_frames(model, cond):
    spec, stats = generate_speculative(model.params, model.config, cond, max_new_tokens=32, sampling_params=GREEDY,
                                       seed=5, return_stats=True, forbid_eos=True, **KW)
    assert stats["passes"] <= stats["frames"] <= 2 * stats["passes"]
    assert spec.shape[-1] >= 30


def test_sampled_speculative_runs_and_reports(model, cond):
    spec, stats = generate_speculative(model.params, model.config, cond, max_new_tokens=24,
                                       sampling_params=SamplingParams(min_p=0.1, repetition_penalty=1.0),
                                       seed=7, return_stats=True, **KW)
    assert spec.ndim == 3 and spec.shape[0] == 1 and (spec >= 0).all()
    assert stats["frames"] == stats["passes"] + stats["accepted"]


def test_refusals(model, cond):
    with pytest.raises(AssertionError, match="repetition penalty"):
        generate_speculative(model.params, model.config, cond, max_new_tokens=8,
                             sampling_params=SamplingParams(min_p=0.1), seed=1, **KW)  # default penalty 3.0
    hybrid = Zonos.from_config(tiny_hybrid_config(), seed=0, dtype=torch.float32, device="cpu")
    with pytest.raises(AssertionError, match="transformer-only"):
        generate_speculative(hybrid.params, hybrid.config, cond, max_new_tokens=8, sampling_params=GREEDY, **KW)


def test_bucket_boundary_matches_sequential(model, cond):
    """max_new_tokens + n_q an exact audio-bucket multiple: the final frame is
    still produced (the 2-frame write is gated per pass)."""
    n_q = model.config.codebook_dimension
    kw = dict(max_new_tokens=64 - n_q, sampling_params=GREEDY, seed=11, forbid_eos=True, audio_bucket=64, **KW)
    seq = G.generate(model.params, model.config, cond, **kw)
    spec = generate_speculative(model.params, model.config, cond, **kw)
    assert spec.shape[-1] == seq.shape[-1]
    np.testing.assert_array_equal(spec, seq)


def test_greedy_int8_codes_and_stats_equal_jax():
    """int8 weights and the int8 KV cache: the port's codes, passes and
    acceptance equal JAX's ``generate_speculative`` at greedy, and its codes
    equal sequential greedy decoding."""
    jm = JZonos.from_config(j_tiny(), seed=0, dtype=jnp.float32).quantize()
    params = params_from_jax(jax.tree.map(np.asarray, jm.params))
    cfg = tiny_transformer_config()
    cd = j_make_cond_dict(text="int8 drafts", speaker=np.zeros((1, 1, 128), np.float32))
    cond = np.asarray(jm.prepare_conditioning(cd), np.float32)
    want, jstats = JS.generate_speculative(jm.params, jm.config, cond, max_new_tokens=48, cfg_scale=2.0,
                                           sampling_params=JSP(top_k=1, min_p=0.0, repetition_penalty=1.0),
                                           seed=2, dtype=jnp.float32, kv_int8=True, return_stats=True)
    got, stats = generate_speculative(params, cfg, cond, max_new_tokens=48, sampling_params=GREEDY, seed=2,
                                      kv_int8=True, return_stats=True, **KW)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert stats == jstats
    seq = G.generate(params, cfg, cond, max_new_tokens=48, sampling_params=GREEDY, seed=2, kv_int8=True, **KW)
    n = min(seq.shape[-1], got.shape[-1])
    np.testing.assert_array_equal(got[..., :n], seq[..., :n])
