"""LoRA fine-tuning: low-rank adapters over the backbone's projections (port
of ``zonos_tpu/training/lora.py``).

The base weights stay frozen; rank-r factors A [L, in, r] and B [L, r, out]
are trained over the layer-stacked projections, then kept apart or folded
into the weights with ``merge_lora``. The step computes the loss of
``W + scale·A@B``, merged as JAX's step merges it, so gradients reach A and
B only and the base is never written. Only float base params can be adapted:
quantized trees are refused (``TypeError``), as are missing targets
(``KeyError``).

Adapters are saved as one ``.npz`` with keys "<target>/a" and "<target>/b",
the JAX package's format: each package reads the other's file.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from zonos_tpu_torch.config import ZonosConfig
from zonos_tpu_torch.training.train import OptState, Optimizer, loss_terms, value_and_grad

# The backbone projections adapted by default: attention in/out and both MLP projections.
DEFAULT_TARGETS: tuple[str, ...] = (
    "layers/attn/in_proj",
    "layers/attn/out_proj",
    "layers/mlp/fc1",
    "layers/mlp/fc2",
)


class LoraState(NamedTuple):
    lora: dict  # {"path": {"a": [L, in, r], "b": [L, r, out]}}, updated in place
    opt_state: OptState
    step: int


def _get(tree: dict, path: str):
    node = tree
    for key in path.split("/"):
        if not isinstance(node, dict) or key not in node:
            return None
        node = node[key]
    return node


def _set(tree: dict, path: str, value) -> dict:
    """A copy of ``tree`` with ``tree[path]`` replaced (shallow copies along the path)."""
    keys = path.split("/")
    out = dict(tree)
    node = out
    for key in keys[:-1]:
        node[key] = dict(node[key])
        node = node[key]
    node[keys[-1]] = value
    return out


def init_lora(backbone_params: dict, rank: int = 8, seed: int = 0, targets: Sequence[str] = DEFAULT_TARGETS,
              dtype=torch.float32) -> dict:
    """A ~ N(0, 1/rank) and B zero, so the adapter starts as a no-op. A is
    drawn from a ``torch.Generator`` seeded with ``seed`` on the params' device
    (the JAX package's ``jax.random`` stream cannot be replayed here)."""
    lora = {}
    gen = None
    for path in targets:
        w = _get(backbone_params, path)
        if w is None:
            raise KeyError(f"LoRA target {path!r} not found in backbone params "
                           "(hybrid backbones: pass targets= for the attn groups)")
        if isinstance(w, dict):
            raise TypeError(f"LoRA target {path!r} is quantized ({list(w)}); adapt the float checkpoint instead")
        if gen is None:
            gen = torch.Generator(device=w.device)
            gen.manual_seed(seed)
        n_layer, d_in, d_out = w.shape
        a = torch.randn((n_layer, d_in, rank), generator=gen, dtype=torch.float32, device=w.device) / rank ** 0.5
        lora[path] = {"a": a.to(dtype), "b": torch.zeros((n_layer, rank, d_out), dtype=dtype, device=w.device)}
    return lora


def lora_delta(adapter: dict, scale: float) -> torch.Tensor:
    """scale · A@B as a stacked [L, in, out] update."""
    return scale * torch.einsum("lir,lro->lio", adapter["a"], adapter["b"])


def merge_lora(backbone_params: dict, lora: dict, scale: float = 2.0) -> dict:
    """A copy of the backbone with each adapter folded in (W ← W + scale·A@B)."""
    merged = backbone_params
    for path, adapter in lora.items():
        w = _get(merged, path)
        merged = _set(merged, path, w + lora_delta(adapter, scale).to(w.dtype))
    return merged


def lora_leaves(lora: dict) -> list:
    """The adapter's factors in a fixed order (targets sorted, then a, b)."""
    return [lora[t][k] for t in sorted(lora) for k in ("a", "b")]


def init_lora_state(lora: dict, optimizer: Optimizer) -> LoraState:
    return LoraState(lora=lora, opt_state=optimizer.init(lora_leaves(lora)), step=0)


def lora_loss_terms(base_params: dict, cfg: ZonosConfig, lora: dict, cond_emb, delayed_codes, loss_mask,
                    scale: float = 2.0, remat: bool = False):
    """``train.loss_terms`` of the base with the adapter merged in (the adapter forward)."""
    params = dict(base_params)
    params["backbone"] = merge_lora(base_params["backbone"], lora, scale)
    return loss_terms(params, cfg, cond_emb, delayed_codes, loss_mask, remat=remat)


def build_lora_train_step(cfg: ZonosConfig, optimizer: Optimizer, base_params: dict, scale: float = 2.0,
                          remat: bool = False):
    """Returns ``step(state, cond_emb, delayed_codes, loss_mask) → (state, loss)``.

    ``base_params`` is the frozen model tree (embeddings, backbone, heads);
    gradients flow only into the adapter factors, which are updated in place.
    """

    def step(state: LoraState, cond_emb, delayed_codes, loss_mask):
        leaves = lora_leaves(state.lora)
        loss, grads = value_and_grad(
            lambda c, d, m: lora_loss_terms(base_params, cfg, state.lora, c, d, m, scale=scale, remat=remat),
            leaves, 1, cond_emb, delayed_codes, loss_mask,
        )
        optimizer.update(grads, state.opt_state, leaves)
        return LoraState(state.lora, state.opt_state, state.step + 1), loss

    return step


def save_lora_npz(path: str, lora: dict) -> None:
    """The adapter as one .npz: keys "<target>/a" and "<target>/b" (bf16 factors
    are written as f32, numpy having no bf16)."""
    flat = {}
    for target, adapter in lora.items():
        for factor in ("a", "b"):
            t = adapter[factor].detach().cpu()
            flat[f"{target}/{factor}"] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    np.savez(path, **flat)


def load_lora_npz(path: str, device="cpu") -> dict:
    """An adapter written by either package's ``save_lora_npz``, on ``device``."""
    lora: dict = {}
    with np.load(path) as z:
        for key in z.files:
            target, factor = key.rsplit("/", 1)
            lora.setdefault(target, {})[factor] = torch.from_numpy(np.array(z[key])).to(device)
    return lora
