"""Device mesh and tensor-parallel layouts on ``torch.distributed`` (port of
``zonos_tpu/parallel/mesh.py``).

* mesh axes ``("dp", "tp")`` over the ranks of the default process group,
  rank r at (r // tp, r % tp), as JAX reshapes its devices to (dp, tp);
* **dp** shards the generation or training batch (``batch_rows``);
* **tp** (Megatron-style) shards attention heads and MLP hidden widths:
  column-parallel in_proj and fc1, row-parallel out_proj and fc2, so each
  block ends in one all-reduce over tp (``parallel.comm``);
* small per-model weights (norms, embeddings, heads) replicate.

The PartitionSpec trees are JAX's, entry for entry. JAX's specs only name
a layout and XLA moves whatever data a product needs; here each rank holds
its shard as a plain tensor and the collectives are explicit, so two
column splits are head-wise rather than contiguous: the packed qkv
projection gives each rank its own q, k and v heads (``[q_r | k_r | v_r]``),
and the packed MLP fc1 its own columns of y and of the gate
(``[y_r | gate_r]``). Everything else splits contiguously, the Mamba2
in_proj included: its output is gathered before the conv and the scan,
which run replicated on every rank.

``make_mesh`` builds the dp and tp subgroups with the backend it is given
(``nccl``: one card per rank; ``gloo``: CPU or CUDA tensors, several ranks
may share a card) and a gloo group for host-side exchange of results.
``spawn`` starts ranks as processes with a ``file://`` store in a temporary
directory, so no network port is needed.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import shutil
import tempfile
import time

import torch
import torch.distributed as dist

from zonos_tpu_torch.config import BackboneConfig, ZonosConfig
from zonos_tpu_torch.models.hybrid import layer_groups
from zonos_tpu_torch.ops.quant import is_quantized, is_quantized4

BACKENDS = ("nccl", "gloo")


def P(*entries) -> tuple:
    """A partition spec: one entry per leading axis, "tp" on the sharded one
    (JAX's ``PartitionSpec``); missing trailing entries are unsharded."""
    return tuple(entries)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in a (dp, tp) mesh and the groups it talks over."""

    dp: int
    tp: int
    rank: int
    device: torch.device
    dp_group: object  # the ranks of this rank's tp index: gradients and losses sum over it
    tp_group: object  # the ranks of this rank's dp index: activations reduce over it
    host_group: object  # every rank, gloo: numpy results

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp


def mesh_device(backend: str, device, rank: int, world: int) -> torch.device:
    """The device of ``rank``: the card unless ``device`` names the CPU.

    ``None`` or an index-free ``"cuda"`` means card ``rank % cards`` (card 0
    for every rank of a gloo group on one card). ``nccl`` needs one card per
    rank and raises otherwise; nothing falls back to the CPU or to gloo.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("zonos_tpu_torch.parallel runs on CUDA devices by default and none is available; "
                               "pass device='cpu' explicitly to run the ranks on the CPU")
        if device.index is None:
            device = torch.device("cuda", rank % torch.cuda.device_count())
    if backend == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if device.type != "cuda" or cards < world:
            raise ValueError(f"nccl needs one card per rank: {world} ranks on {device.type}, {cards} cards")
    return device


def _mesh_shape(world: int, dp: int | None, tp: int | None) -> tuple[int, int]:
    if dp is None and tp is None:
        dp, tp = 1, world
    elif dp is None:
        dp = world // tp
    elif tp is None:
        tp = world // dp
    if dp * tp != world:
        raise ValueError(f"dp({dp}) * tp({tp}) != {world} ranks")
    return dp, tp


def make_mesh(dp: int | None = None, tp: int | None = None, *, backend: str, device=None) -> Mesh:
    """A ("dp", "tp") mesh over the ranks of the initialized default group.
    Defaults: all ranks on tp. Every rank must call it, in the same order."""
    if not dist.is_initialized():
        mesh_device(backend, device, 0, 1)  # a missing card is named first
        raise RuntimeError("make_mesh: no process group; call torch.distributed.init_process_group "
                           "first, or start the ranks with parallel.spawn")
    world, rank = dist.get_world_size(), dist.get_rank()
    device = mesh_device(backend, device, rank, world)
    dp, tp = _mesh_shape(world, dp, tp)
    tp_group = dp_group = None
    for i in range(dp):  # new_group is collective: every rank creates every group
        g = dist.new_group(list(range(i * tp, (i + 1) * tp)), backend=backend)
        tp_group = g if rank // tp == i else tp_group
    for j in range(tp):
        g = dist.new_group(list(range(j, world, tp)), backend=backend)
        dp_group = g if rank % tp == j else dp_group
    host = dist.new_group(list(range(world)), backend="gloo")
    return Mesh(dp=dp, tp=tp, rank=rank, device=device, dp_group=dp_group, tp_group=tp_group, host_group=host)


# ---------------------------------------------------------------------------
# Launcher
# ---------------------------------------------------------------------------

def _rank_main(rank, fn, world, backend, device, tmp, args, timeout):
    # The rank's card is bound before the group starts: nccl's communicators
    # (the default group's and every new_group's) take the current device,
    # and device_id makes the default group's bind to this card at once.
    dev = mesh_device(backend, device, rank, world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{tmp}/store", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout),
                            device_id=dev if backend == "nccl" else None)
    try:
        out = fn(backend, device, *args)
    finally:
        dist.destroy_process_group()
    part = os.path.join(tmp, f"rank{rank}.pkl")
    with open(part + ".tmp", "wb") as f:
        pickle.dump(out, f)
    os.replace(part + ".tmp", part)


def spawn(fn, world: int, backend: str, device=None, *args, timeout: float = 900.0) -> list:
    """Run ``fn(backend, device, *args)`` in ``world`` new processes that form
    the default process group, and return each rank's result (pickled back).

    ``fn`` must be importable by name (a module-level function): the ranks
    start from a fresh interpreter and import its module. A rank that raises
    ends every rank and raises here; so does the ``timeout`` (seconds), which
    is also each collective's timeout. ``device`` defaults to the card: rank
    r takes card r % cards (``mesh_device``), made its current device before
    the group starts.
    """
    for r in range(world):
        mesh_device(backend, device, r, world)  # raise here, before any process starts
    tmp = tempfile.mkdtemp(prefix="zonos_ranks_")
    try:
        ctx = torch.multiprocessing.start_processes(
            _rank_main, args=(fn, world, backend, device, tmp, args, timeout), nprocs=world, join=False,
            start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    p.kill()
                    p.join()
                raise TimeoutError(f"spawn: {world} ranks of {fn.__name__} did not finish in {timeout} s")
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:  # written by our own ranks
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# PartitionSpec trees (JAX's, entry for entry)
# ---------------------------------------------------------------------------

def transformer_param_specs(cfg: BackboneConfig) -> dict:
    """Specs matching init_transformer_params' layout: every layer leaf has a
    leading L axis (never sharded); in_proj and fc1 column-parallel, out_proj
    and fc2 row-parallel."""
    return {
        "layers": {
            "norm1": {"scale": P(), "bias": P()},
            "attn": {"in_proj": P(None, None, "tp"), "out_proj": P(None, "tp", None)},
            "norm2": {"scale": P(), "bias": P()},
            "mlp": {"fc1": P(None, None, "tp"), "fc2": P(None, "tp", None)},
        },
        "norm_f": {"scale": P(), "bias": P()},
    }


def hybrid_param_specs(cfg: BackboneConfig) -> dict:
    """Specs matching init_hybrid_params' layout: attention groups are single
    layers, Mamba groups layer-stacked runs with a leading R axis. The Mamba2
    in_proj is column-parallel over its packed output axis and out_proj
    row-parallel; conv taps, the SSD scalars and the gated norm replicate
    (the scan runs on gathered activations)."""
    groups = []
    for kind, _ in layer_groups(cfg):
        if kind == "attn":
            groups.append({
                "norm": {"scale": P(), "bias": P()},
                "mixer": {"in_proj": P(None, "tp"), "in_proj_b": P("tp"), "out_proj": P("tp", None),
                          "out_proj_b": P()},
                "norm2": {"scale": P(), "bias": P()},
                "mlp": {"fc1": P(None, "tp"), "fc2": P("tp", None)},
            })
        else:
            groups.append({
                "norm": {"scale": P(), "bias": P()},
                "mixer": {"in_proj": P(None, None, "tp"), "conv_w": P(), "conv_b": P(), "dt_bias": P(),
                          "A_log": P(), "D": P(), "norm_w": P(), "out_proj": P(None, "tp", None)},
                "norm2": {"scale": P(), "bias": P()},
                "mlp": {"fc1": P(None, None, "tp"), "fc2": P(None, "tp", None)},
            })
    return {"groups": tuple(groups), "norm_f": {"scale": P(), "bias": P()}}


def zonos_param_specs(cfg: ZonosConfig) -> dict:
    """Specs for the whole Zonos params tree (either backbone). Embeddings,
    the heads (9 × 1025 outputs: not tp-divisible) and the conditioners
    replicate."""
    bb = cfg.backbone
    return {
        "embeddings": P(),
        "heads": P(),
        "backbone": hybrid_param_specs(bb) if bb.is_hybrid else transformer_param_specs(bb),
        "prefix_conditioner": None,
    }


def _quant_specs(wspec: tuple, tree: dict) -> dict:
    """A weight's spec over its quantized {"q","s"} / {"q4","s4"} dict: ``q``
    takes it; ``s`` keeps the output axis but never shards its size-1 axis;
    int4 splits K into (G, group/2), so the K entry moves to the G axis."""
    def full(spec, rank):
        return list(spec) + [None] * (rank - len(spec))

    out = {}
    for k, leaf in tree.items():
        if k == "q":
            entries = full(wspec, leaf.dim())
        elif k == "s":
            entries = full(wspec, leaf.dim())
            entries[-2] = None
        elif k in ("q4", "s4"):
            w = full(wspec, leaf.dim() - 1)
            entries = w[:-2] + [w[-2], None, w[-1]]
        else:
            entries = [None] * leaf.dim()
        out[k] = tuple(entries)
    return out


def named(spec_tree, param_tree):
    """A tree shaped like ``param_tree`` of full-rank spec tuples (one entry
    per axis). Missing or None specs replicate; quantized weight dicts are
    leaves whose spec expands per component (``_quant_specs``)."""
    def walk(spec, tree):
        if is_quantized(tree) or is_quantized4(tree):
            return _quant_specs(spec if isinstance(spec, tuple) else P(), tree)
        if isinstance(tree, dict):
            return {k: walk(spec.get(k) if isinstance(spec, dict) else None, v) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            specs = spec if isinstance(spec, (tuple, list)) and len(spec) == len(tree) else [None] * len(tree)
            return type(tree)(walk(s, v) for s, v in zip(specs, tree))
        if tree is None:
            return None
        s = spec if isinstance(spec, tuple) and all(e in (None, "tp") for e in spec) else P()
        return tuple(s) + (None,) * (tree.dim() - len(s))

    return walk(spec_tree, param_tree)


# ---------------------------------------------------------------------------
# Shards
# ---------------------------------------------------------------------------

_QUANT_PARTS = ("q", "s", "q4", "s4")


def _column_segments(cfg: BackboneConfig, path: str, n: int) -> list[int]:
    """How a column-parallel leaf's last axis (of size n) splits: one
    contiguous run, or segments each split over tp (qkv by heads, [y | gate])."""
    keys = [k for k in path.split("/") if k not in _QUANT_PARTS]
    if keys[-2:] == ["mlp", "fc1"]:
        return [n // 2, n // 2]
    if keys[-1] in ("in_proj", "in_proj_b") and keys[-2] in ("attn", "mixer"):
        if keys[-2] == "attn" or _group_kind(cfg, keys) == "attn":
            a = cfg.attn_cfg
            return [a.num_heads * cfg.head_dim, a.num_heads_kv * cfg.head_dim, a.num_heads_kv * cfg.head_dim]
    return [n]


def _group_kind(cfg: BackboneConfig, keys: list[str]) -> str:
    return layer_groups(cfg)[int(keys[keys.index("groups") + 1])][0]


def take_shard(t: torch.Tensor, axis: int, segments: list[int], tp: int, r: int) -> torch.Tensor:
    """Rank r's part of ``t`` along ``axis``: the r-th of tp equal pieces of
    each segment, concatenated in segment order."""
    parts, off = [], 0
    for s in segments:
        if s % tp:
            raise ValueError(f"a segment of {s} along axis {axis} of {tuple(t.shape)} does not split over tp={tp}")
        w = s // tp
        parts.append(t.narrow(axis, off + r * w, w))
        off += s
    return torch.cat(parts, dim=axis) if len(parts) > 1 else parts[0]


def _placed(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A replicated leaf on ``device`` with its strides kept (the int8 heads are
    a view of rows padded to 16 bytes, which K1 reads by TMA)."""
    if t.device == device:
        return t
    base = t if t._base is None else t._base
    return base.to(device).as_strided(t.shape, t.stride(), t.storage_offset() - base.storage_offset())


def shard_tree(cfg: ZonosConfig, params: dict, tp: int, tp_rank: int, device=None) -> dict:
    """Rank ``tp_rank``'s local params: leaves that JAX's specs shard over tp
    cut as ``take_shard`` says (contiguous on ``device``), the rest
    replicated as they are."""
    specs = named(zonos_param_specs(cfg), params)
    device = torch.device(device) if device is not None else None

    def walk(tree, spec, path):
        if isinstance(tree, dict):
            return {k: walk(v, spec[k], f"{path}{k}/") for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(walk(v, s, f"{path}{i}/") for i, (v, s) in enumerate(zip(tree, spec)))
        if tree is None:
            return None
        dev = device or tree.device
        if "tp" not in spec or tp == 1:
            return _placed(tree, dev)
        axis = spec.index("tp")
        n = tree.shape[axis]
        segments = _column_segments(cfg.backbone, path[:-1], n) if axis == tree.dim() - 1 else [n]
        return take_shard(tree, axis, segments, tp, tp_rank).to(dev).contiguous()

    return walk(params, specs, "")


def shard_axes(cfg: ZonosConfig, params: dict) -> dict[str, int | None]:
    """{path: the axis tp splits, or None} for every tensor leaf, with
    ``training.train.named_leaves``' paths (the port's groups are lists, so
    every tuple of ``named`` is a leaf's spec)."""
    out = {}

    def walk(spec, path):
        if isinstance(spec, dict):
            for k, v in spec.items():
                walk(v, f"{path}{k}/")
        elif isinstance(spec, list):
            for i, v in enumerate(spec):
                walk(v, f"{path}{i}/")
        elif spec is not None:
            out[path[:-1]] = spec.index("tp") if "tp" in spec else None

    walk(named(zonos_param_specs(cfg), params), "")
    return out


def shard_params(mesh: Mesh, cfg: ZonosConfig, params: dict) -> dict:
    """This rank's local params on the mesh's device (``shard_tree``)."""
    return shard_tree(cfg, params, mesh.tp, mesh.tp_rank, mesh.device)


def local_config(cfg: ZonosConfig, tp: int) -> ZonosConfig:
    """The config one tp rank's shards compute: 1/tp of the query and KV heads
    (head_dim kept) and of the MLP widths. Caches sized from it hold this
    rank's KV heads only; the Mamba2 dims stay whole (the scan is replicated)."""
    if tp == 1:
        return cfg
    bb = cfg.backbone
    a = bb.attn_cfg
    for name, v in (("num_heads", a.num_heads), ("num_heads_kv", a.num_heads_kv),
                    ("attn_mlp_d_intermediate", bb.attn_mlp_d_intermediate), ("d_intermediate", bb.d_intermediate)):
        if v % tp:
            raise ValueError(f"{name} {v} does not split over tp={tp}")
    attn = dataclasses.replace(a, num_heads=a.num_heads // tp, num_heads_kv=a.num_heads_kv // tp,
                               head_dim=bb.head_dim)
    bb = dataclasses.replace(bb, attn_cfg=attn, attn_mlp_d_intermediate=bb.attn_mlp_d_intermediate // tp,
                             d_intermediate=bb.d_intermediate // tp)
    return dataclasses.replace(cfg, backbone=bb)


def batch_rows(mesh: Mesh, n: int) -> slice:
    """This rank's rows of a batch of n split over dp (JAX's ``batch_sharding``)."""
    if n % mesh.dp:
        raise ValueError(f"a batch of {n} does not split over dp={mesh.dp}")
    b = n // mesh.dp
    return slice(mesh.dp_rank * b, (mesh.dp_rank + 1) * b)
