"""Hybrid Mamba2 + attention backbone (port of ``zonos_tpu/models/hybrid.py``).

Pre-norm residual blocks whose mixer is a Mamba2 SSD (most layers) or GQA
attention (the layers of ``attn_layer_idx``), each followed by a gated-SiLU
MLP where the config gives one, and a final LayerNorm (an RMSNorm with
``rms_norm_f``). The config's Granite scalars (``BackboneConfig``) scale
the input, each branch, the attention's scores and the final hidden state;
at their defaults they do nothing. Params keep the JAX layout:
``params["groups"]`` holds, in layer order, one dict per attention layer and
one layer-stacked dict per run of consecutive Mamba layers (every leaf with
a leading run axis R; ``layer_groups``). A Python loop over a run's layers
takes the place of JAX's ``lax.scan`` and writes each layer's conv and SSD
states into the cache in place.

The decode step (S = 1) runs through the CUDA kernels where they apply, as
the transformer's does: int8 projections (Mamba and attention in_proj and
out_proj) through K1, int4 ones (the MLPs' too) through K4, the int8 MLPs
through K3 (``fused_mlp_int8``) and attention over the int8 KV cache through
K2. The prefill stays on torch.matmul.

Under tensor parallelism (a ``mesh`` with tp > 1) the attention layers and
the MLPs run this rank's heads and columns as the transformer's do, a
row-parallel output bias added once after the reduce; the Mamba2 mixer
follows ``ops.mamba2``'s tp path (in_proj column-parallel and gathered, the
conv and scan replicated, out_proj row-parallel).
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.utils.checkpoint

from zonos_tpu_torch.config import BackboneConfig
from zonos_tpu_torch.models.transformer import (
    _kv_quantize, _layer, _write_index_i32, _write_slots, mlp, row_parallel,
)
from zonos_tpu_torch.ops.attention import (
    causal_prefix_mask, decode_mask, gqa_attention, gqa_attention_quantized,
)
from zonos_tpu_torch.ops.cuda_attention import attn_core_int8
from zonos_tpu_torch.ops.mamba2 import init_mamba2_params, mamba2_dims, mamba2_prefill, mamba2_step
from zonos_tpu_torch.ops.norms import layer_norm, rms_norm
from zonos_tpu_torch.ops.quant import qeinsum
from zonos_tpu_torch.ops.rope import apply_rope_neox, rope_rows
from zonos_tpu_torch.parallel.comm import copy_to_tp


@functools.lru_cache(maxsize=32)
def layer_groups(cfg: BackboneConfig) -> tuple[tuple[str, int], ...]:
    """Groups in layer order: ("attn", layer index) or ("mamba", run length)."""
    groups: list[tuple[str, int]] = []
    run = 0
    for i in range(cfg.n_layer):
        if i in cfg.attn_layer_idx:
            if run:
                groups.append(("mamba", run))
                run = 0
            groups.append(("attn", i))
        else:
            run += 1
    if run:
        groups.append(("mamba", run))
    return tuple(groups)


def ssd_state_dtype(compute_dtype: torch.dtype) -> torch.dtype:
    """The SSD state's dtype in the cache: bf16 for a bf16 model, else f32.
    (The JAX package also reads an environment override; the port has none.)"""
    return torch.bfloat16 if compute_dtype == torch.bfloat16 else torch.float32


@dataclasses.dataclass
class HybridCache:
    """Sequence state per group, updated in place; None where a group is of the other kind.

    Attention groups: kv_k/kv_v [B, S, Hkv, Dh] in the model dtype, or
    head-major int8 [B, Hkv, S, Dh] with f32 scales kv_ks/kv_vs [B, Hkv, S]
    (the transformer's int8 layout, which K2 reads). Mamba runs: conv
    [R, B, K-1, conv_dim] in the model dtype and ssm [R, B, H, N, P] in
    ``ssd_state_dtype``.
    """

    kv_k: list
    kv_v: list
    conv: list
    ssm: list
    kv_ks: list
    kv_vs: list

    @classmethod
    def create(cls, cfg: BackboneConfig, batch_size: int, max_seqlen: int, dtype=torch.bfloat16,
               kv_int8: bool = False, device=None) -> "HybridCache":
        c = cls([], [], [], [], [], [])
        hkv, dh = cfg.attn_cfg.num_heads_kv, cfg.head_dim
        for kind, v in layer_groups(cfg):
            if kind == "attn":
                shape = (batch_size, hkv, max_seqlen, dh) if kv_int8 else (batch_size, max_seqlen, hkv, dh)
                kv_dtype = torch.int8 if kv_int8 else dtype
                c.kv_k.append(torch.zeros(shape, dtype=kv_dtype, device=device))
                c.kv_v.append(torch.zeros(shape, dtype=kv_dtype, device=device))
                for scales in (c.kv_ks, c.kv_vs):
                    scales.append(torch.ones((batch_size, hkv, max_seqlen), dtype=torch.float32, device=device)
                                  if kv_int8 else None)
                c.conv.append(None)
                c.ssm.append(None)
            else:
                dims = mamba2_dims(cfg.d_model, cfg.ssm_cfg)
                s = cfg.ssm_cfg
                for kv in (c.kv_k, c.kv_v, c.kv_ks, c.kv_vs):
                    kv.append(None)
                c.conv.append(torch.zeros((v, batch_size, s.d_conv - 1, dims["conv_dim"]), dtype=dtype,
                                          device=device))
                c.ssm.append(torch.zeros((v, batch_size, dims["nheads"], s.d_state, s.headdim),
                                         dtype=ssd_state_dtype(dtype), device=device))
        return c

    def reset(self) -> "HybridCache":
        """Back to the state ``create`` gives, in place."""
        for t in (*self.kv_k, *self.kv_v, *self.conv, *self.ssm):
            if t is not None:
                t.zero_()
        for s in (*self.kv_ks, *self.kv_vs):
            if s is not None:
                s.fill_(1.0)
        return self

    @property
    def quantized(self) -> bool:
        return any(s is not None for s in self.kv_ks)


def _norm(x: torch.Tensor, p: dict, cfg: BackboneConfig) -> torch.Tensor:
    if cfg.rms_norm:
        return rms_norm(x, p["scale"], cfg.norm_epsilon)
    return layer_norm(x, p["scale"], p.get("bias"), cfg.norm_epsilon)


def _residual(x: torch.Tensor, branch: torch.Tensor, cfg: BackboneConfig) -> torch.Tensor:
    """x + residual_multiplier · branch, rounded once."""
    return torch.add(x, branch, alpha=cfg.residual_multiplier)


def _attn_mixer(p: dict, cfg: BackboneConfig, x: torch.Tensor, cache: HybridCache | None, gi: int,
                write_start, mask, attend_len: int, pos_offset=None, decode_args=None,
                mesh=None) -> torch.Tensor:
    """Attention mixer of group gi over normed x [B, S, D], writing the cache in place."""
    b, s, _ = x.shape
    hq, hkv, dh = cfg.attn_cfg.num_heads, cfg.attn_cfg.num_heads_kv, cfg.head_dim
    qkv = qeinsum("bsd,de->bse", copy_to_tp(x, mesh), p["in_proj"])
    if p.get("in_proj_b") is not None:
        qkv = qkv + p["in_proj_b"].to(qkv.dtype)
    q, k, v = torch.split(qkv, [hq * dh, hkv * dh, hkv * dh], dim=-1)
    q, k, v = q.reshape(b, s, hq, dh), k.reshape(b, s, hkv, dh), v.reshape(b, s, hkv, dh)

    rdim = cfg.attn_cfg.rotary_emb_dim or 0  # None: no rotary in the hybrid's attention
    if rdim > 0:
        steps = torch.arange(s, device=x.device)
        positions = write_start + steps if pos_offset is None else write_start + steps[None, :] - pos_offset[:, None]
        freqs = rope_rows(positions, rdim)
        q = torch.cat([apply_rope_neox(q[..., :rdim], freqs), q[..., rdim:]], dim=-1)
        k = torch.cat([apply_rope_neox(k[..., :rdim], freqs), k[..., rdim:]], dim=-1)

    scale = cfg.attention_multiplier
    if cache is None:
        att = gqa_attention(q, k, v, mask, scale)
    elif cache.kv_ks[gi] is not None:
        kc, vc, ks, vs = cache.kv_k[gi], cache.kv_v[gi], cache.kv_ks[gi], cache.kv_vs[gi]
        kq, knew = _kv_quantize(k)
        vq, vnew = _kv_quantize(v)
        _write_slots(kc, 2, write_start, kq.transpose(1, 2))
        _write_slots(vc, 2, write_start, vq.transpose(1, 2))
        _write_slots(ks, 2, write_start, knew.transpose(1, 2))
        _write_slots(vs, 2, write_start, vnew.transpose(1, 2))
        window = (kc[:, :, :attend_len], ks[:, :, :attend_len], vc[:, :, :attend_len], vs[:, :, :attend_len])
        if decode_args is not None:
            write_index, pad_amount, gap_start, gap_len = decode_args
            att = attn_core_int8(q.contiguous(), *window, write_index, pad_amount, gap_start=gap_start,
                                 gap_len=gap_len, sm_scale=scale)
        else:
            att = gqa_attention_quantized(q, *window, mask, scale=scale)
    else:
        _write_slots(cache.kv_k[gi], 1, write_start, k)
        _write_slots(cache.kv_v[gi], 1, write_start, v)
        att = gqa_attention(q, cache.kv_k[gi][:, :attend_len], cache.kv_v[gi][:, :attend_len], mask, scale)
    out = row_parallel("bse,ed->bsd", att.reshape(b, s, hq * dh), p["out_proj"], mesh)
    if p.get("out_proj_b") is not None:
        out = out + p["out_proj_b"].to(out.dtype)
    return out


def _mamba_layer(layer_p: dict, cfg: BackboneConfig, x: torch.Tensor, conv_state, ssm_state, seq_mask,
                 prefill: bool, mesh=None):
    h = _norm(x, layer_p["norm"], cfg)
    if prefill:
        out, conv_state, ssm_state = mamba2_prefill(layer_p["mixer"], h, cfg.ssm_cfg, seq_mask, mesh=mesh)
    else:
        out, conv_state, ssm_state = mamba2_step(layer_p["mixer"], h, cfg.ssm_cfg, conv_state, ssm_state,
                                                 mesh=mesh)
    x = _residual(x, out, cfg)
    if layer_p.get("mlp") is not None:
        x = _residual(x, mlp(_norm(x, layer_p["norm2"], cfg), layer_p["mlp"], mesh), cfg)
    return x, conv_state, ssm_state


def hybrid_forward(
    params: dict,
    cfg: BackboneConfig,
    x: torch.Tensor,  # [B, S, D]
    cache: HybridCache | None,
    write_start,  # an int, or a decode step's device int64 [1]
    pad_amount: torch.Tensor,  # [B] int32
    attend_len: int,
    pos_offset: torch.Tensor | None = None,  # [B] logical-position offsets (decode)
    gap_len: torch.Tensor | None = None,  # [B] dead cache span after the prefill
    gap_start: int = 0,
    remat: bool = False,
    mesh=None,  # parallel.mesh.Mesh for tensor parallelism (cfg: local_config's)
) -> tuple[torch.Tensor, HybridCache | None]:
    """All hybrid layers over x; S > 1 is the prefill, S == 1 a decode step.
    ``x`` is the whole backbone input (the conditioning prefix and the code
    embeddings), which ``embedding_multiplier`` scales.

    The cache (KV, conv and SSD states) is updated in place. With cache None
    the prefill runs cache-free: attention over x itself, Mamba states from
    zeros and dropped (the training forward; ``remat`` then recomputes each
    layer in the backward pass, ``torch.utils.checkpoint``). Left padding
    (``pad_amount``) is masked out of the attention and kept out of the
    Mamba states. A Mamba run's group may be ``split_layers``' list of its
    layers. Returns (final-normed hidden [B, S, D], the cache).
    """
    b, s, _ = x.shape
    prefill = s > 1
    decode_args = seq_mask = None
    if prefill:
        mask = causal_prefix_mask(s, pad_amount)
        seq_mask = torch.arange(s, device=x.device)[None, :] >= pad_amount[:, None]
    elif cache is None:
        raise ValueError("hybrid_forward: a decode step needs a cache")
    elif cache.quantized:  # K2 masks from these itself
        mask = None
        decode_args = (_write_index_i32(write_start, x.device), pad_amount.to(torch.int32), gap_start,
                       None if gap_len is None else gap_len.to(torch.int32))
    else:
        mask = decode_mask(attend_len, pad_amount, write_start, gap_start=gap_start, gap_len=gap_len)

    def attn_layer(gp, gi, x):
        out = _attn_mixer(gp["mixer"], cfg, _norm(x, gp["norm"], cfg), cache, gi, write_start, mask,
                          attend_len if cache is not None else s, None if prefill else pos_offset, decode_args,
                          mesh)
        x = _residual(x, out, cfg)
        if gp.get("mlp") is not None:
            x = _residual(x, mlp(_norm(x, gp["norm2"], cfg), gp["mlp"], mesh), cfg)
        return x

    def mamba_layer_no_cache(layer_p, x):
        return _mamba_layer(layer_p, cfg, x, None, None, seq_mask, prefill, mesh)[0]

    if cfg.embedding_multiplier != 1.0:
        x = x * cfg.embedding_multiplier
    ckpt = remat and cache is None
    for gi, (kind, run) in enumerate(layer_groups(cfg)):
        gp = params["groups"][gi]
        if kind == "attn":
            x = (torch.utils.checkpoint.checkpoint(attn_layer, gp, gi, x, use_reentrant=False) if ckpt
                 else attn_layer(gp, gi, x))
            continue
        for i in range(run):
            layer_p = gp[i] if isinstance(gp, list) else _layer(gp, i)
            if cache is None:
                x = (torch.utils.checkpoint.checkpoint(mamba_layer_no_cache, layer_p, x, use_reentrant=False)
                     if ckpt else mamba_layer_no_cache(layer_p, x))
                continue
            x, conv_state, ssm_state = _mamba_layer(layer_p, cfg, x, cache.conv[gi][i], cache.ssm[gi][i],
                                                    seq_mask, prefill, mesh)
            cache.conv[gi][i].copy_(conv_state)
            cache.ssm[gi][i].copy_(ssm_state)
    nf = params["norm_f"]
    x = (rms_norm(x, nf["scale"], cfg.norm_epsilon) if cfg.rms_norm_f
         else layer_norm(x, nf["scale"], nf.get("bias"), cfg.norm_epsilon))
    if cfg.logits_scaling != 1.0:  # the heads are linear and bias-free: logits / logits_scaling
        x = x / cfg.logits_scaling
    return x, cache


def split_hybrid_layers(params: dict, cfg: BackboneConfig) -> dict:
    """``params`` with each Mamba run's group cut into a list of its layers'
    slices, which ``hybrid_forward`` takes as they are: a decode segment cuts
    them once, not at every step."""
    groups = [gp if kind == "attn" else [_layer(gp, i) for i in range(run)]
              for gp, (kind, run) in zip(params["groups"], layer_groups(cfg))]
    return {**params, "groups": groups}


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def stack_layers(layers: list):
    """A list of same-structured layer dicts → one dict with every tensor
    stacked along a new leading axis (None leaves kept)."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: stack_layers([lay[k] for lay in layers]) for k in first}
    return None if first is None else torch.stack(layers)


def init_hybrid_params(generator: torch.Generator, cfg: BackboneConfig, dtype=torch.bfloat16, device=None) -> dict:
    """Random-init params (normal / sqrt(fan_in) linears, unit norms), the Mamba runs stacked."""
    d = cfg.d_model
    hq, hkv, dh = cfg.attn_cfg.num_heads, cfg.attn_cfg.num_heads_kv, cfg.head_dim

    def lin(cin, cout):
        w = torch.randn((cin, cout), generator=generator, dtype=torch.float32, device=device)
        return (w / cin ** 0.5).to(dtype)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=device)

    def norm_p():
        p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
        if not cfg.rms_norm:
            p["bias"] = zeros(d)
        return p

    def with_mlp(layer, f):
        if f:
            layer["norm2"] = norm_p()
            layer["mlp"] = {"fc1": lin(d, 2 * f), "fc2": lin(f, d)}
        return layer

    groups = []
    for kind, run in layer_groups(cfg):
        if kind == "attn":
            mixer = {
                "in_proj": lin(d, (hq + 2 * hkv) * dh),
                "in_proj_b": zeros((hq + 2 * hkv) * dh) if cfg.attn_cfg.qkv_proj_bias else None,
                "out_proj": lin(hq * dh, d),
                "out_proj_b": zeros(d) if cfg.attn_cfg.out_proj_bias else None,
            }
            groups.append(with_mlp({"norm": norm_p(), "mixer": mixer, "norm2": None, "mlp": None},
                                   cfg.attn_mlp_d_intermediate))
        else:
            groups.append(stack_layers([
                with_mlp({"norm": norm_p(), "mixer": init_mamba2_params(generator, d, cfg.ssm_cfg, dtype, device),
                          "norm2": None, "mlp": None}, cfg.d_intermediate)
                for _ in range(run)
            ]))
    norm_f = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if not cfg.rms_norm_f:
        norm_f["bias"] = zeros(d)
    return {"groups": groups, "norm_f": norm_f}
