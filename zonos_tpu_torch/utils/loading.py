"""Reference checkpoints → the port's params (port of ``zonos_tpu/utils/loading.py``).

Turns the reference state dict (torch module names, one tensor per layer,
[out, in] linear weights) into the port's layout, which is the JAX
package's: a leading n_layer axis on the transformer's leaves, [in, out]
matmul weights, the hybrid's Mamba runs stacked (``loading_hybrid``). The
reference's quirks are handled as the JAX package does:

* legacy per-codebook ``heads.N.weight`` are fused into one matrix;
* the 1026 embedding rows are zero-padded to the next multiple of
  ``pad_vocab_to_multiple_of`` (1032).
"""

from __future__ import annotations

from typing import Mapping

import torch

from zonos_tpu_torch.config import ZonosConfig
from zonos_tpu_torch.utils.safetensors_io import load_file


def load_safetensors(path: str) -> dict[str, torch.Tensor]:
    """A safetensors file → name → CPU tensor in its stored dtype."""
    return load_file(path)


def _pad_rows(w: torch.Tensor, rows: int) -> torch.Tensor:
    if w.shape[0] >= rows:
        return w[:rows]
    return torch.cat([w, w.new_zeros((rows - w.shape[0], *w.shape[1:]))])


class _Converter:
    """Casts and places state-dict tensors: ``arr`` as stored, ``t`` transposed
    ([out, in] → [in, out]), each in ``dtype`` (or f32 where asked) on ``device``."""

    def __init__(self, sd: Mapping[str, torch.Tensor], dtype, device):
        self.sd, self.dtype, self.device = sd, dtype, device

    def arr(self, key: str, dtype=None) -> torch.Tensor:
        return torch.as_tensor(self.sd[key]).to(device=self.device, dtype=dtype or self.dtype)

    def t(self, key: str) -> torch.Tensor:
        return self.arr(key).T.contiguous()

    def stack(self, fmt: str, n: int, transpose: bool = False) -> torch.Tensor:
        get = self.t if transpose else self.arr
        return torch.stack([get(fmt.format(i)) for i in range(n)])


def torch_state_dict_to_params(sd: Mapping[str, torch.Tensor], cfg: ZonosConfig, dtype=torch.bfloat16,
                               device="cpu") -> dict:
    """A reference Zonos state dict (tensors or arrays) → the port's params tree on ``device``."""
    c = _Converter(sd, dtype, device)
    n_q = cfg.codebook_dimension
    params = {"embeddings": torch.stack([_pad_rows(c.arr(f"embeddings.{k}.weight"), cfg.vocab_size)
                                         for k in range(n_q)])}
    if "fused_heads.weight" in sd:
        heads = c.arr("fused_heads.weight")
    else:
        heads = torch.cat([c.arr(f"heads.{k}.weight") for k in range(n_q)])
    params["heads"] = heads.T.contiguous()  # [D, n_q * 1025]

    if cfg.backbone.is_hybrid:
        from zonos_tpu_torch.utils.loading_hybrid import hybrid_state_dict_to_params

        params["backbone"] = hybrid_state_dict_to_params(sd, cfg, dtype, device)
    else:
        n = cfg.backbone.n_layer
        fmt = "backbone.layers.{}."
        params["backbone"] = {
            "layers": {
                "norm1": {"scale": c.stack(fmt + "norm.weight", n), "bias": c.stack(fmt + "norm.bias", n)},
                "attn": {"in_proj": c.stack(fmt + "mixer.in_proj.weight", n, True),
                         "out_proj": c.stack(fmt + "mixer.out_proj.weight", n, True)},
                "norm2": {"scale": c.stack(fmt + "norm2.weight", n), "bias": c.stack(fmt + "norm2.bias", n)},
                "mlp": {"fc1": c.stack(fmt + "mlp.fc1.weight", n, True),
                        "fc2": c.stack(fmt + "mlp.fc2.weight", n, True)},
            },
            "norm_f": {"scale": c.arr("backbone.norm_f.weight"), "bias": c.arr("backbone.norm_f.bias")},
        }
    params["prefix_conditioner"] = conditioner_state_dict_to_params(sd, cfg, dtype, device)
    return params


def conditioner_state_dict_to_params(sd: Mapping[str, torch.Tensor], cfg: ZonosConfig, dtype=torch.bfloat16,
                                     device="cpu") -> dict:
    """``prefix_conditioner.*`` tensors → the name-keyed conditioner tree (Fourier weights f32)."""
    c = _Converter(sd, dtype, device)
    out: dict = {}
    for i, spec in enumerate(cfg.prefix_conditioner.conditioners):
        base = f"prefix_conditioner.conditioners.{i}"
        p: dict = {}
        if spec.type == "EspeakPhonemeConditioner":
            p["phoneme_embed"] = c.arr(f"{base}.phoneme_embedder.weight")
        elif spec.type == "FourierConditioner":
            p["fourier_weight"] = c.arr(f"{base}.weight", torch.float32)
        elif spec.type == "IntegerConditioner":
            p["int_embed"] = c.arr(f"{base}.int_embedder.weight")
        p["project"] = _projection_from_sd(c, f"{base}.project", spec.projection)
        if spec.uncond_type == "learned":
            p["uncond_vector"] = c.arr(f"{base}.uncond_vector")
        out[spec.name] = p
    out["_project"] = _projection_from_sd(c, "prefix_conditioner.project", cfg.prefix_conditioner.projection)
    out["_norm"] = {"scale": c.arr("prefix_conditioner.norm.weight"), "bias": c.arr("prefix_conditioner.norm.bias")}
    return out


def _projection_from_sd(c: _Converter, base: str, kind: str) -> dict:
    if kind == "linear":
        return {"w": c.t(f"{base}.weight"), "b": c.arr(f"{base}.bias")}
    if kind == "mlp":
        return {"w1": c.t(f"{base}.0.weight"), "b1": c.arr(f"{base}.0.bias"),
                "w2": c.t(f"{base}.2.weight"), "b2": c.arr(f"{base}.2.bias")}
    return {}
