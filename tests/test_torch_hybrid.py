"""The port's hybrid backbone (``zonos_tpu_torch/models/hybrid.py``) against
the JAX package's and against the torch oracle of ``tests/oracles``.

Tiny hybrid config (d 64, 3 layers: Mamba, attention, Mamba), float32 on
the CPU: hidden states of the prefill and 8 decode steps at 1e-4 (bf16-layout
and int8 KV caches), the quantized params leaf for leaf, greedy codes
identical to JAX's ``generate`` (float, int8 and int4; B 1 and 2; int8 KV on
and off), and ``generate_audio`` / ``generate_stream`` at 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zonos_tpu.codec import dac as JDAC
from zonos_tpu.config import tiny_hybrid_config as j_tiny
from zonos_tpu.models import hybrid as JH
from zonos_tpu.models.zonos import Zonos as JZonos
from zonos_tpu.ops.sampling import SamplingParams as JSP
from zonos_tpu.runtime import generate as JG
from zonos_tpu.runtime import streaming as JS
from zonos_tpu_torch.bridge import dac_params_from_jax, hybrid_cache_from_jax, params_from_jax
from zonos_tpu_torch.codec.dac import DACAutoencoder
from zonos_tpu_torch.config import DACConfig, tiny_hybrid_config
from zonos_tpu_torch.models import hybrid as TH
from zonos_tpu_torch.models.backbone import backbone_forward, create_cache
from zonos_tpu_torch.models.zonos import Zonos
from zonos_tpu_torch.ops.quant import quantize_hybrid_params
from zonos_tpu_torch.ops.sampling import SamplingParams
from zonos_tpu_torch.runtime import generate as TG
from zonos_tpu_torch.runtime import streaming as TS
from zonos_tpu_torch.utils.export import params_to_torch_state_dict

CFG_J, CFG_T = j_tiny(), tiny_hybrid_config()
DAC_KW = dict(encoder_hidden_size=8, downsampling_ratios=(2, 4), decoder_hidden_size=32,
              upsampling_ratios=(4, 2), n_codebooks=9, codebook_size=1024, codebook_dim=4, hidden_size=24)
GREEDY = {"temperature": 0.0}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# JAX's forward jitted (config and attend_len static): one trace for the
# prefill and one for the decode steps, instead of op-by-op dispatch.
j_forward = jax.jit(JH.hybrid_forward, static_argnums=(1, 6))


@pytest.fixture(scope="module")
def models():
    """The JAX model (float, int8, int4) and the port's bridged copies."""
    jm = JZonos.from_config(CFG_J, seed=0, dtype=jnp.float32)
    out = {}
    for bits in (None, 8, 4):
        m = jm if bits is None else jm.quantize(bits=bits)
        out[bits] = (m, params_from_jax(_np_tree(m.params)))
    return out


def test_layer_groups_match_jax():
    from zonos_tpu.config import zonos_v01_hybrid_config as j_full
    from zonos_tpu_torch.config import zonos_v01_hybrid_config

    assert TH.layer_groups(CFG_T.backbone) == JH.layer_groups(CFG_J.backbone) == (
        ("mamba", 1), ("attn", 1), ("mamba", 1))
    assert TH.layer_groups(zonos_v01_hybrid_config().backbone) == JH.layer_groups(j_full().backbone)


@pytest.mark.parametrize("kv_int8", [False, True])
def test_forward_prefill_and_decode_match_jax(models, kv_int8):
    """Prefill (row 1 left-padded by 3) and 8 decode steps through the
    backbone, caches updated in place, against JAX's functional caches."""
    jm, tp = models[None]
    cfg_j, cfg_t = CFG_J.backbone, CFG_T.backbone
    b, s, cache_len = 2, 12, 32
    x = np.random.default_rng(1).normal(size=(b, s + 8, 64)).astype(np.float32) * 0.5
    pad = np.array([0, 3], np.int32)
    jcache = JH.HybridCache.create(cfg_j, b, cache_len, jnp.float32, kv_int8=kv_int8)
    tcache = create_cache(cfg_t, b, cache_len, torch.float32, kv_int8=kv_int8, device="cpu")
    ref, jcache = j_forward(jm.params["backbone"], cfg_j, jnp.asarray(x[:, :s]), jcache, jnp.int32(0),
                            jnp.asarray(pad), s)
    got, tcache = backbone_forward(tp["backbone"], cfg_t, torch.from_numpy(x[:, :s]), tcache, 0,
                                   torch.from_numpy(pad), s)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    for t in range(8):
        xt = x[:, s + t:s + t + 1]
        ref, jcache = j_forward(jm.params["backbone"], cfg_j, jnp.asarray(xt), jcache, jnp.int32(s + t),
                                jnp.asarray(pad), cache_len)
        got, tcache = backbone_forward(tp["backbone"], cfg_t, torch.from_numpy(xt), tcache, s + t,
                                       torch.from_numpy(pad), cache_len)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    bridged = hybrid_cache_from_jax(_np_tree(jcache))
    for name in ("kv_k", "kv_v", "kv_ks", "kv_vs", "conv", "ssm"):
        for mine, theirs in zip(getattr(tcache, name), getattr(bridged, name)):
            assert (mine is None) == (theirs is None)
            if mine is not None:
                assert mine.dtype == theirs.dtype and mine.shape == theirs.shape
                np.testing.assert_allclose(mine.float().numpy(), theirs.float().numpy(), rtol=1e-4, atol=1e-4)


def test_bridged_cache_continues_the_jax_decode(models):
    """A JAX prefill's cache, bridged, carries the port's next decode step to JAX's."""
    jm, tp = models[8]
    cfg_j, cfg_t = CFG_J.backbone, CFG_T.backbone
    x = np.random.default_rng(2).normal(size=(2, 9, 64)).astype(np.float32) * 0.5
    pad = jnp.zeros((2,), jnp.int32)
    jcache = JH.HybridCache.create(cfg_j, 2, 16, jnp.float32, kv_int8=True)
    _, jcache = j_forward(jm.params["backbone"], cfg_j, jnp.asarray(x[:, :8]), jcache, jnp.int32(0), pad, 8)
    tcache = hybrid_cache_from_jax(_np_tree(jcache))
    assert tcache.quantized and tcache.ssm[0].shape == (1, 2, 8, 16, 16)
    ref, _ = j_forward(jm.params["backbone"], cfg_j, jnp.asarray(x[:, 8:]), jcache, jnp.int32(8), pad, 16)
    got, _ = backbone_forward(tp["backbone"], cfg_t, torch.from_numpy(x[:, 8:]), tcache, 8,
                              torch.zeros(2, dtype=torch.int32), 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("rms_norm,rotary", [(False, 0), (False, 8), (True, 16)])
def test_hidden_states_match_the_torch_oracle(rms_norm, rotary):
    """The port's own init, exported to the reference layout by the port,
    loaded into the mamba-ssm transcription of tests/oracles: prefill hidden
    states within 2e-4 (JAX's own oracle test's bound)."""
    from tests.oracles.hybrid_torch_ref import HybridBackboneRef

    base = tiny_hybrid_config(n_layer=4)
    bb = dataclasses.replace(base.backbone, d_intermediate=96, rms_norm=rms_norm,
                             attn_cfg=dataclasses.replace(base.backbone.attn_cfg, rotary_emb_dim=rotary or None))
    cfg = dataclasses.replace(base, backbone=bb)
    model = Zonos.from_config(cfg, seed=4, dtype=torch.float32, device="cpu")
    oracle = HybridBackboneRef(cfg).eval()
    oracle.load_reference_state_dict(params_to_torch_state_dict(model.params, cfg))
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 24, 64)).astype(np.float32) * 0.3)
    with torch.no_grad():
        ref = oracle(x)
    got, _ = TH.hybrid_forward(model.params["backbone"], bb, x, None, 0, torch.zeros(2, dtype=torch.int32), 24)
    assert (got - ref).abs().max().item() < 2e-4


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_hybrid_params_equals_jax_leaf_for_leaf(models, bits):
    _, tp = models[None]
    _, ref = models[bits]
    got = quantize_hybrid_params(tp, bits=bits)

    def eq(a, b, path):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                eq(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, (list, tuple)):
            assert len(a) == len(b), path
            for i, (u, v) in enumerate(zip(a, b)):
                eq(u, v, f"{path}[{i}]")
        elif a is None:
            assert b is None, path
        else:
            assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), path

    eq(got, ref, "")
    heads = got["heads"]["q"]
    assert heads.stride(0) % 16 == 0  # K1's layout for the int8 heads
    run = got["backbone"]["groups"][0]["mixer"]["in_proj"]
    assert run["q" if bits == 8 else "q4"].shape[0] == 1  # the stacked run keeps its leading axis


@pytest.mark.parametrize("bits", [None, 8, 4], ids=["float", "int8", "int4"])
@pytest.mark.parametrize("b,kv_int8", [(1, False), (1, True), (2, False), (2, True)])
def test_greedy_codes_identical_to_jax(models, bits, b, kv_int8):
    jm, tp = models[bits]
    cond = np.random.default_rng(b).normal(size=(2 * b, 10, 64)).astype(np.float32) * 0.5
    ref, ref_len = JG.generate(jm.params, CFG_J, cond, max_new_tokens=24, batch_size=b,
                               sampling_params=JSP(temperature=0.0), seed=0, dtype=jnp.float32, kv_int8=kv_int8,
                               return_lengths=True)
    got, got_len = TG.generate(tp, CFG_T, cond, max_new_tokens=24, batch_size=b,
                               sampling_params=SamplingParams(temperature=0.0), seed=0, dtype=torch.float32,
                               kv_int8=kv_int8, return_lengths=True, device="cpu")
    assert got.shape == ref.shape == (b, 9, 24)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got_len, ref_len)


@pytest.fixture(scope="module")
def facades(models):
    jm, tp = models[8]
    jcfg = JDAC.DACConfig(**DAC_KW)
    jdac = JDAC.init_dac_params(jax.random.key(0), jcfg)
    jm._autoencoder = JDAC.DACAutoencoder(params=jdac, cfg=jcfg, dtype=jnp.float32, frame_bucket=8)
    port = Zonos(CFG_T, tp, dtype=torch.float32, device="cpu")
    port.default_kv_int8 = True
    port._autoencoder = DACAutoencoder(params=dac_params_from_jax(_np_tree(jdac)), cfg=DACConfig(**DAC_KW),
                                       dtype=torch.float32, frame_bucket=8, device="cpu")
    return jm, port


def test_generate_audio_matches_jax(facades):
    jm, port = facades
    cond = np.random.default_rng(3).normal(size=(2, 10, 64)).astype(np.float32) * 0.5
    ref, ref_len = JS.generate_audio(jm.params, jm.config, cond, jm.autoencoder, max_new_tokens=80,
                                     sampling_params=GREEDY, seed=0, chunk_frames=32, dtype=jnp.float32, kv_int8=True)
    wav, lengths = port.generate_audio(cond, max_new_tokens=80, sampling_params=GREEDY, seed=0)
    np.testing.assert_array_equal(lengths, ref_len)
    assert wav.shape == ref.shape
    np.testing.assert_allclose(wav, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("b", [1, 2])
def test_generate_stream_matches_jax(facades, b):
    jm, port = facades
    cond = np.random.default_rng(5).normal(size=(2 * b, 10, 64)).astype(np.float32) * 0.5
    kw = dict(max_new_tokens=40, batch_size=b, sampling_params=GREEDY, seed=0, first_chunk_frames=6,
              chunk_frames=8, kv_int8=True)
    ref = list(JS.generate_stream(jm.params, jm.config, cond, autoencoder=jm.autoencoder, dtype=jnp.float32, **kw))
    got = list(TS.generate_stream(port.params, port.config, cond, autoencoder=port.autoencoder,
                                  dtype=torch.float32, device="cpu", **kw))
    assert len(got) == len(ref) >= 2
    for (g, _), (r, _) in zip(got, ref):
        if b == 1:
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-4)
        else:
            np.testing.assert_allclose(g[0], r[0], rtol=0, atol=1e-4)
            np.testing.assert_array_equal(g[1], r[1])


def test_port_hybrid_facade_end_to_end():
    """A hybrid built by the port itself: from_config, quantize (int8, int4),
    the hybrid conditioners and generate, all on the CPU."""
    from zonos_tpu_torch.conditioning.cond_dict import make_cond_dict

    model = Zonos.from_config(CFG_T, seed=1, dtype=torch.float32, device="cpu")
    assert [s.name for s in CFG_T.prefix_conditioner.conditioners][-4:] == [
        "vqscore_8", "ctc_loss", "dnsmos_ovrl", "speaker_noised"]
    cond = model.prepare_conditioning(make_cond_dict(text="hi", speaker=np.zeros((1, 1, 128), np.float32)))
    assert cond.shape[0] == 2 and cond.shape[-1] == 64
    for bits in (8, 4):
        q = model.quantize(bits=bits)
        assert q.default_kv_int8
        codes = q.generate(cond, max_new_tokens=12, seed=3)
        assert codes.shape[:2] == (1, 9) and codes.min() >= 0 and codes.max() <= 1023
