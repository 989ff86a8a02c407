"""The four tensor-parallel operators (Megatron's), as autograd Functions
over the mesh's tp group:

| operator       | forward                      | backward          |
| -------------- | ---------------------------- | ----------------- |
| copy_to_tp     | identity                     | all-reduce        |
| reduce_from_tp | all-reduce                   | identity          |
| gather_from_tp | all-gather on the last axis  | own slice         |
| scatter_to_tp  | own slice of the last axis   | all-gather        |

``copy_to_tp`` goes before a column-parallel product (each rank's input
gradient covers only its columns), ``reduce_from_tp`` after a row-parallel
one. The models reduce a row-parallel product's f32 partials and cast the
sum once, as one device casts its one f32 sum.
``torch.distributed.nn.functional.all_reduce`` is not used: its backward
all-reduces again, which would give tp times the gradient.

The gather is an all-reduce into a zeroed full-width buffer: exact (each
element is one rank's value plus zeros), and the collective gloo runs on
CUDA tensors as well as on CPU ones, so both backends take one path. With
no mesh, or tp 1, every operator is the identity.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The sum (or ``op``) of x over ``group``, in a new tensor."""
    out = x.clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def _gather_last(x: torch.Tensor, mesh) -> torch.Tensor:
    n = x.shape[-1]
    buf = x.new_zeros(*x.shape[:-1], n * mesh.tp)
    buf[..., mesh.tp_rank * n:(mesh.tp_rank + 1) * n] = x
    dist.all_reduce(buf, group=mesh.tp_group)
    return buf


def _own_slice(x: torch.Tensor, mesh) -> torch.Tensor:
    n = x.shape[-1] // mesh.tp
    return x[..., mesh.tp_rank * n:(mesh.tp_rank + 1) * n].contiguous()


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh.tp_group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(x, mesh.tp_group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _gather_last(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _own_slice(g, ctx.mesh), None


class _ScatterToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _own_slice(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _gather_last(g, ctx.mesh), None


def _tp(mesh) -> bool:
    return mesh is not None and mesh.tp > 1


def copy_to_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    return _CopyToTP.apply(x, mesh) if _tp(mesh) else x


def reduce_from_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    return _ReduceFromTP.apply(x, mesh) if _tp(mesh) else x


def gather_from_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    return _GatherFromTP.apply(x, mesh) if _tp(mesh) else x


def scatter_to_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    return _ScatterToTP.apply(x, mesh) if _tp(mesh) else x


def tp_agree(tokens: torch.Tensor, mesh) -> None:
    """Raise on every tp rank at once unless all of them hold these tokens.

    The heads are replicated, so the tp ranks compute the same logits and,
    with the same generators, draw the same tokens; this checks it. One
    all-reduce of (t, -t) under MAX gives every rank the largest and the
    smallest value of each token, so all ranks agree on the verdict and none
    is left waiting in a later collective.
    """
    if not _tp(mesh):
        return
    t = tokens.to(torch.int64)
    both = all_reduce(torch.stack([t, -t]), mesh.tp_group, op=dist.ReduceOp.MAX)
    if not torch.equal(both[0], -both[1]):
        raise RuntimeError("tensor-parallel ranks drew different tokens")
