"""Collectives over one axis of a :class:`~.mesh.Mesh` — the counterpart
of ``deepspeed_tpu/parallel/collectives.py``.

The JAX functions are named-axis collectives inside ``shard_map``; these
run ``torch.distributed`` over the axis's process group (NCCL on the
card, gloo on the CPU):

  psum / pmean / pmax   all_reduce
  reduce_scatter        reduce_scatter_tensor (ZeRO's gradient partition)
  all_gather            all_gather_into_tensor (ZeRO's parameter gather)
  pbroadcast_from       broadcast from one index of the axis
  reduce_to             reduce onto one index of the axis

plus the autograd pairs that Megatron tensor parallelism and ZeRO-3 need:
:func:`copy_to_axis` (identity forward, all-reduce backward),
:func:`reduce_from_axis` (all-reduce forward, identity backward) and
:func:`gather_from_axis` (all-gather forward, reduce-scatter backward).

Each function returns a new tensor and leaves its input as it was.  On a
local mesh (no process group) an axis has one rank and each collective
computes that one-rank result; on a joined mesh every call runs its
collective, whatever the group's size.  A failed collective raises.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import Mesh


def _reduce(x, mesh: Mesh, axis: str, op):
    out = x.clone()
    g = mesh.group(axis)
    if g is not None:
        dist.all_reduce(out, op=op, group=g)
    return out


def psum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    return _reduce(x, mesh, axis, dist.ReduceOp.SUM)


def pmean(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    return psum(x, mesh, axis) / mesh.axis_size(axis)


def pmax(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    return _reduce(x, mesh, axis, dist.ReduceOp.MAX)


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str,
               dim: int = 0) -> torch.Tensor:
    """The axis's pieces concatenated along ``dim``, in axis order."""
    g = mesh.group(axis)
    x0 = x.movedim(dim, 0).contiguous()
    if g is None:
        return x0.movedim(0, dim).clone()
    n = mesh.axis_size(axis)
    out = torch.empty((n * x0.shape[0],) + tuple(x0.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x0, group=g)
    return out.movedim(0, dim).contiguous()


def reduce_scatter(x: torch.Tensor, mesh: Mesh, axis: str,
                   dim: int = 0) -> torch.Tensor:
    """Sum over the axis; each rank keeps its own 1/n of ``dim``."""
    g = mesh.group(axis)
    x0 = x.movedim(dim, 0).contiguous()
    if g is None:
        return x0.movedim(0, dim).clone()
    n = mesh.axis_size(axis)
    if x0.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not divide by the {axis} axis's {n}")
    out = torch.empty((x0.shape[0] // n,) + tuple(x0.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, x0, op=dist.ReduceOp.SUM, group=g)
    return out.movedim(0, dim).contiguous()


def pbroadcast_from(x: torch.Tensor, mesh: Mesh, axis: str,
                    root: int = 0) -> torch.Tensor:
    """Axis index ``root``'s ``x`` on every rank of the axis (the others'
    ``x`` gives only shape and dtype)."""
    out = x.clone()
    g = mesh.group(axis)
    if g is not None:
        dist.broadcast(out, src=mesh.axis_ranks(axis)[root], group=g)
    return out


def reduce_to(x: torch.Tensor, mesh: Mesh, axis: str,
              root: int = 0) -> torch.Tensor:
    """The axis's sum on axis index ``root``; other ranks get a tensor
    whose values are unspecified."""
    out = x.clone()
    g = mesh.group(axis)
    if g is not None:
        dist.reduce(out, dst=mesh.axis_ranks(axis)[root], group=g)
    return out


class _CopyToAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.mesh, ctx.axis), None, None


class _ReduceFromAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return psum(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFromAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter(g, ctx.mesh, ctx.axis, ctx.dim), None, None,
                None)


def copy_to_axis(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Megatron's ``f``: a replicated activation entering a column-parallel
    product — identity forward, its gradient all-reduced backward."""
    return _CopyToAxis.apply(x, mesh, axis)


def reduce_from_axis(x: torch.Tensor, mesh: Mesh, axis: str
                     ) -> torch.Tensor:
    """Megatron's ``g``: the partial sums of a row-parallel product (or a
    vocab-parallel lookup) all-reduced forward, the gradient passed
    through backward."""
    return _ReduceFromAxis.apply(x, mesh, axis)


def gather_from_axis(x: torch.Tensor, mesh: Mesh, axis: str,
                     dim: int = 0) -> torch.Tensor:
    """ZeRO-3's gather: the pieces all-gathered along ``dim`` forward, the
    gradient reduce-scattered back to the pieces backward."""
    return _GatherFromAxis.apply(x, mesh, axis, dim)
