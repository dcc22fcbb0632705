"""The rank mesh — the counterpart of ``deepspeed_tpu/parallel/mesh.py``.

The JAX package lays its devices out as one ``jax.sharding.Mesh`` with
the named axes ``(pipe, data, seq, model)``.  The port lays the job's
ranks out the same way, row-major (``ProcessTopology``), so that JAX
device *i* and port rank *i* hold the same coordinate, and it holds one
``torch.distributed`` process group per axis — the ranks that differ
from this one only along that axis:

  - ``data``  the data-parallel group (gradient all-reduce, ZeRO's
              reduce-scatter and parameter gathers);
  - ``model`` the Megatron tensor-parallel group (the all-reduces of the
              row-parallel products and of the vocab-parallel embedding
              and loss);
  - ``pipe``  the pipeline's stages (the point-to-point boundary tensors,
              ``pipe/p2p.py``, and the sums of the pipe-replicated
              gradients, norms and loss);
  - ``seq``   the sequence-parallel group (ring attention's K/V
              rotations and Ulysses' all-to-alls, ``parallel/
              sequence.py``, the loss's token sums and the gradient sums
              of the seq-replicated parameters).

The JAX module's ``replicated`` and ``data_sharded`` (``NamedSharding``
factories) have no counterpart: placement in the port is explicit — the
training engine
slices each rank's pieces itself (``runtime/zero.py``), the batch
contract gives each rank its own rows, and :class:`RankSharding` (a spec
over this mesh, the counterpart of a ``NamedSharding``) names the slice
of a tensor a rank holds, as the serving engine places its parameters
and caches.

A mesh built with no process group (one process, nothing joined) is
local: its axes are all 1 and the collectives over it compute the
one-rank result in place (``parallel/collectives.py``).
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch.distributed as dist

from .topology import ProcessTopology

PIPE_AXIS = "pipe"
DATA_AXIS = "data"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"
DEFAULT_AXES: Tuple[str, str, str, str] = (
    PIPE_AXIS, DATA_AXIS, SEQ_AXIS, MODEL_AXIS)
#: the axes the port builds process groups for
GROUP_AXES = (PIPE_AXIS, DATA_AXIS, SEQ_AXIS, MODEL_AXIS)


class Mesh:
    """This rank's view of the job: the axis sizes, its coordinate, and
    (``groups``) the process group of each of its axes, None for a local
    mesh."""

    def __init__(self, dims: Tuple[int, int, int, int], rank: int = 0,
                 groups: Optional[Dict[str, object]] = None):
        self.topology = ProcessTopology(list(DEFAULT_AXES),
                                        [int(d) for d in dims])
        self.shape = dict(zip(DEFAULT_AXES, self.topology.dims))
        self.rank = int(rank)
        self.size = self.topology.world_size()
        self._groups = groups
        if groups is None and self.size != 1:
            raise ValueError(f"a local mesh has one rank, not {self.size}")
        self.coord = self.topology.get_coord(self.rank)

    @property
    def is_local(self) -> bool:
        return self._groups is None

    def group(self, axis: str):
        """The process group of this rank's ``axis`` (``"world"``: every
        rank), None on a local mesh."""
        if self._groups is None:
            return None
        return self._groups[axis]

    def axis_index(self, axis: str) -> int:
        return getattr(self.coord, axis)

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def axis_ranks(self, axis: str) -> List[int]:
        """The global ranks of this rank's ``axis`` group, by axis index."""
        d = self.coord._asdict()
        out = []
        for i in range(self.shape[axis]):
            d[axis] = i
            out.append(self.topology.get_rank(**d))
        return out

    def __repr__(self):
        return (f"Mesh({self.shape}, rank={self.rank}"
                f"{', local' if self.is_local else ''})")


class RankSharding(NamedTuple):
    """A tensor's placement over a :class:`Mesh`: ``spec`` names the mesh
    axis each dim is split over (None, or a dim past its end: whole on
    every rank), and this rank holds the slice :meth:`box` gives — the
    counterpart of a ``jax.sharding.NamedSharding``."""
    mesh: Mesh
    spec: Tuple[Optional[str], ...]

    def box(self, shape) -> Tuple[Tuple[int, int], ...]:
        """This rank's ``[start, stop)`` per dim of a tensor of ``shape``."""
        out = []
        for d, n in enumerate(shape):
            axis = self.spec[d] if d < len(self.spec) else None
            k = 1 if axis is None else self.mesh.axis_size(axis)
            if n % k:
                raise ValueError(f"dim {d} of {tuple(shape)} does not "
                                 f"divide by the {axis} axis's {k}")
            i = 0 if axis is None else self.mesh.axis_index(axis)
            out.append((i * (n // k), (i + 1) * (n // k)))
        return tuple(out)

    def shard_shape(self, shape) -> Tuple[int, ...]:
        return tuple(b - a for a, b in self.box(shape))

    def piece(self, t):
        """This rank's slice of the whole tensor ``t`` (an owned copy
        unless it is all of ``t``)."""
        p = t[tuple(slice(a, b) for a, b in self.box(t.shape))]
        return p if p.numel() == t.numel() else p.clone()


def build_mesh(pp: int = 1, dp: Optional[int] = None, tp: int = 1,
               sp: int = 1) -> Mesh:
    """Lay the joined job's ranks out over (pipe, data, seq, model),
    row-major — the JAX mesh's ``reshape(pp, dp, sp, tp)`` of its
    devices, so the ``seq`` neighbours of a rank sit ``tp`` ranks apart.

    ``dp=None`` absorbs what the world leaves after pp·sp·tp.  Every rank
    must call it (each new process group is created collectively), in
    the same order.  With no process group joined the mesh is local and
    its axes must all be 1."""
    joined = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if joined else 1
    rank = dist.get_rank() if joined else 0
    if dp is None:
        if world % (pp * tp * sp) != 0:
            raise ValueError(f"world size {world} not divisible by "
                             f"pp*sp*tp={pp * sp * tp}")
        dp = world // (pp * tp * sp)
    if pp * dp * sp * tp != world:
        raise ValueError(
            f"pp*dp*sp*tp = {pp}*{dp}*{sp}*{tp} != world size {world}")
    dims = (pp, dp, sp, tp)
    if not joined:
        return Mesh(dims)
    topo = ProcessTopology(list(DEFAULT_AXES), list(dims))
    groups = {"world": dist.group.WORLD}
    for axis in GROUP_AXES:
        for ranks in topo.get_axis_comm_lists(axis):
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = g
    return Mesh(dims, rank, groups)


def single_device_mesh() -> Mesh:
    """A local mesh of one rank: no process group, every axis 1."""
    return Mesh((1, 1, 1, 1))


def mesh_axis_size(mesh: Mesh, axis: str) -> int:
    return mesh.shape.get(axis, 1)
