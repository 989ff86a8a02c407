"""granite-4.0-h-micro's layers as a Zonos backbone in the port, against the
benchmark's plain reference (``benchmark/reference/granite_h.py``, loaded by
path) on seeded random weights at a tiny size: d 64, 4 layers with attention
at index 1 (4 query and 2 KV heads of 16), an MLP after every layer,
RMSNorm, and the four Granite scalars at non-unit values (embedding 12,
residual 0.22, attention 1/16, logits 8), as ``benchmark/tests/tiny-granite.json``
holds them.

The port is driven as it serves: a prefill of the conditioning prefix and the
first code frame, then teacher-forced decode steps through its cache, one
frame each; the reference runs its full forward over the same inputs. Also
K2's plain version at head dim 64 with a given scale, and the config's dict
form.
"""

import dataclasses
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from zonos_tpu_torch.config import (
    BackboneConfig, ZonosConfig, config_to_dict, tiny_hybrid_config, tiny_transformer_config,
    zonos_v01_hybrid_config, zonos_v01_transformer_config,
)
from zonos_tpu_torch.models.backbone import backbone_forward, create_cache
from zonos_tpu_torch.ops.attention import decode_mask, gqa_attention_quantized
from zonos_tpu_torch.ops.cuda_attention import attn_core_int8
from zonos_tpu_torch.ops.quant import quantize_hybrid_params
from zonos_tpu_torch.runtime.generate import apply_heads, embed_codes
from zonos_tpu_torch.utils.loading import torch_state_dict_to_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)  # granite_h imports benchmark.reference.model


def _load(rel: str, name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


G = _load("benchmark/reference/granite_h.py", "granite_h_reference")
with open(os.path.join(REPO, "benchmark", "tests", "tiny-granite.json")) as _f:
    DOC = json.load(_f)
CFG = ZonosConfig.from_dict(DOC["config"])
SCALARS = ("embedding_multiplier", "residual_multiplier", "attention_multiplier", "logits_scaling")
CFG_SCALE = 2.0
# The float32 port against the float32 reference differs only by the order of
# f32 sums (the chunked SSD against the plain scan, a cached step against the
# full forward): 1.05-1.15e-5 of guided logits of std ~4 (up to ~18) over
# three seeds, 1.6-1.8e-5 with int8 weights and KV. With int8 KV a K or V
# value within an f32 ulp of a rounding boundary could round the other way in
# the two (one int8 step of one position): the int8 tolerance leaves room for
# it. Both lie far below what a dropped setting (0.029-0.042 for the attention
# scale, 1.0 or more for the others) or a bf16 step (0.14-0.17) gives.
TOL = {"float": 1e-4, "int8": 2e-4}


@pytest.fixture(scope="module")
def weights():
    from benchmark.weights import _materialize

    gen = torch.Generator().manual_seed(2**31 + 19)
    (sd,) = _materialize([G.weight_specs(DOC["config"], DOC["phoneme_vocab_size"])], gen, "cpu", torch.float32)
    return sd


@pytest.fixture(scope="module")
def case(weights):
    """(conditioning [2, Lc, D], delayed codes [n_q, T]) of one request."""
    ref = G.Reference(DOC, weights, "cpu", bits=None)
    ids = np.random.default_rng(3).integers(1, DOC["phoneme_vocab_size"], 11)
    values = {"speaker": np.random.default_rng(4).standard_normal(128).astype(np.float32), "language_id": 24}
    codes = np.random.default_rng(5).integers(0, 1024, (CFG.codebook_dimension, 7))
    return ref.conditioning(ids, values), torch.as_tensor(G.model.delay(codes, CFG.masked_token_id))


def port_logits(sd, cfg: ZonosConfig, cond, delayed, kv_int8: bool, dtype=torch.float32) -> torch.Tensor:
    """Guided logits [O, n_q, V] of the port: the prefill over the prefix and
    frame 0, then one cached decode step per later frame."""
    params = torch_state_dict_to_params(sd, cfg, dtype, "cpu")
    if kv_int8:
        params = quantize_hybrid_params(params, bits=8)
    o_n = delayed.shape[1] - cfg.codebook_dimension
    lc = cond.shape[1]
    emb = embed_codes(params["embeddings"], delayed[None, :, :o_n]).expand(2, -1, -1)
    cache = create_cache(cfg.backbone, 2, lc + o_n, dtype, kv_int8=kv_int8, device="cpu")
    pad = torch.zeros(2, dtype=torch.int32)
    x = torch.cat([cond.to(dtype), emb[:, :1]], dim=1)
    out = []
    for t in range(o_n):
        h, cache = backbone_forward(params["backbone"], cfg.backbone, x, cache, write_start=0 if t == 0 else lc + t,
                                    pad_amount=pad, attend_len=x.shape[1] if t == 0 else lc + o_n)
        logits = apply_heads(params["heads"], h[:, -1:], cfg.codebook_dimension)[:, :, 0]
        out.append(logits[1] + (logits[0] - logits[1]) * CFG_SCALE)
        if t + 1 < o_n:
            x = emb[:, t + 1: t + 2]
    return torch.stack(out).float()


def ref_logits(sd, cond, delayed, kv_int8: bool) -> torch.Tensor:
    ref = G.Reference(DOC, sd, "cpu", bits=8 if kv_int8 else None)
    o_n = delayed.shape[1] - CFG.codebook_dimension
    return ref.guided_logits(cond, delayed[:, :o_n], CFG_SCALE)


def _with(cfg: ZonosConfig, **backbone) -> ZonosConfig:
    return dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone, **backbone))


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_cached_decode_matches_the_reference(weights, case, kind):
    cond, delayed = case
    got = port_logits(weights, CFG, cond, delayed, kind == "int8")
    want = ref_logits(weights, cond, delayed, kind == "int8")
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= TOL[kind]


@pytest.mark.parametrize("change", [*SCALARS, "rms_norm_f", "bf16"])
def test_a_dropped_scalar_or_a_bf16_step_fails_the_comparison(weights, case, change):
    """The comparison sees every scalar, and the precision the tests hold."""
    cond, delayed = case
    if change == "bf16":
        got = port_logits(weights, CFG, cond, delayed, False, dtype=torch.bfloat16)
    else:
        default = dataclasses.fields(BackboneConfig)
        got = port_logits(weights, _with(CFG, **{change: next(f.default for f in default if f.name == change)}),
                          cond, delayed, False)
    assert float((got - ref_logits(weights, cond, delayed, False)).abs().max()) > 10 * TOL["float"]


def test_k2_plain_at_head_dim_64_with_a_given_scale():
    """K2's plain version (the CPU path of ``attn_core_int8``) at Dh 64, 4 query
    heads per KV head and Granite's scale equals ``gqa_attention_quantized``
    at that scale, and differs from the default 1/sqrt(64)."""
    g = torch.Generator().manual_seed(7)
    b, hkv, hq, s, dh = 3, 2, 8, 40, 64
    q = torch.randn((b, 1, hq, dh), generator=g)
    kq = torch.randint(-127, 128, (b, hkv, s, dh), generator=g, dtype=torch.int8)
    vq = torch.randint(-127, 128, (b, hkv, s, dh), generator=g, dtype=torch.int8)
    ks, vs = torch.rand((b, hkv, s), generator=g) / 50, torch.rand((b, hkv, s), generator=g) / 50
    wi, pad = torch.tensor([30], dtype=torch.int32), torch.tensor([0, 4, 9], dtype=torch.int32)
    gap = torch.tensor([3, 0, 5], dtype=torch.int32)
    got = attn_core_int8(q, kq, ks, vq, vs, wi, pad, gap_start=12, gap_len=gap, sm_scale=1 / 64)
    mask = decode_mask(s, pad, wi, gap_start=12, gap_len=gap)
    want = gqa_attention_quantized(q, kq, ks, vq, vs, mask, use_qq=False, scale=1 / 64)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    default = attn_core_int8(q, kq, ks, vq, vs, wi, pad, gap_start=12, gap_len=gap)
    assert float((default - got).abs().max()) > 1e-3


@pytest.mark.parametrize("preset", [zonos_v01_transformer_config, zonos_v01_hybrid_config, tiny_transformer_config,
                                    tiny_hybrid_config])
def test_presets_write_the_dict_they_wrote(preset):
    """At their defaults the scalars stay out of ``config_to_dict``: every
    existing config.json keeps its bytes, and the JAX package's reader reads it."""
    d = config_to_dict(preset())
    assert list(d["backbone"]) == ["d_model", "d_intermediate", "attn_mlp_d_intermediate", "n_layer", "ssm_cfg",
                                   "attn_layer_idx", "attn_cfg", "rms_norm", "residual_in_fp32", "norm_epsilon"]
    assert ZonosConfig.from_dict(json.loads(json.dumps(d))) == preset()


def test_granite_config_round_trips():
    d = config_to_dict(CFG)
    assert {k: d["backbone"][k] for k in SCALARS} == {k: DOC["config"]["backbone"][k] for k in SCALARS}
    assert ZonosConfig.from_dict(json.loads(json.dumps(d))) == CFG
    assert CFG.backbone.is_hybrid and CFG.backbone.head_dim == 16


def test_a_bf16_cache_holds_the_recurrent_state_the_roofline_counts():
    """The benchmark's least step time (``roofline_ssm``) counts each row's
    SSD and conv states at 2 bytes an element: the cache of a bf16 model
    holds them so, where an f32 SSD state would hold about twice that."""
    from benchmark import roofline_ssm
    from zonos_tpu_torch.models.hybrid import HybridCache

    cache = HybridCache.create(CFG.backbone, 3, 32, dtype=torch.bfloat16, kv_int8=True)
    held = sum(t.nbytes for t in (*cache.conv, *cache.ssm) if t is not None)
    assert held == 3 * roofline_ssm.state_bytes_per_row(DOC["config"])
