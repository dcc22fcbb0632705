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
:func:`gather_from_axis` (all-gather forward, reduce-scatter backward);
the two that sequence parallelism needs on the ``seq`` axis, each with
the transpose JAX's AD takes as its backward: :func:`seq_all_to_all`
(``lax.all_to_all(..., tiled=True)``: backward is the all-to-all with
the dims swapped) and :func:`seq_ring_shift` (``ppermute`` to the next
rank: backward shifts to the previous one, its send and receive posted
together); and the two that expert parallelism needs on ``data``:
:func:`data_all_to_all` (the token exchange between the data ranks and
the ranks that hold their experts, backward the reverse exchange) and
:func:`sum_over_axis` (a sum every rank's loss takes whole: all-reduce
forward and backward).  Gloo moves no CUDA tensor in an all-to-all or a
point-to-point call, so on a gloo group the all-to-alls and the ring
shift stage a CUDA tensor through host memory, each staging counted in
``seq_stats`` or ``ep_stats``.  Compressed data parallelism adds
:func:`data_all_gather` (a gather over ``data`` of 1-bit Adam's packed
signs and scales, ``onebit_stats``, or of a CSR gradient's indices and
values, ``csr_stats``) and 1-bit Adam's packed-sign all-to-all,
:func:`onebit_all_to_all`; both stage a CUDA tensor through host memory
on gloo too.  Expert × sequence parallelism adds :func:`seq_all_gather`
(the MoE layer's routing counts over ``seq``, counted in ``seq_stats``
beside the all-to-alls and rotations).

Each function returns a new tensor and leaves its input as it was.  On a
local mesh (no process group) an axis has one rank and each collective
computes that one-rank result; on a joined mesh every call runs its
collective, whatever the group's size.  A failed collective raises.
``calls`` counts each function's calls in this process (a layout's
tests show with it that a path runs no collective), and inside
:func:`recorded` every collective that crosses ranks is logged with its
dtype and element count (a step's wire sizes, which the JAX package's
tests read from the compiled program's HLO).
"""
from __future__ import annotations

import collections
import contextlib
import time

import torch
import torch.distributed as dist

from .mesh import DATA_AXIS, SEQ_AXIS, Mesh

#: calls per collective in this process (``reduce`` counts psum, pmean
#: and pmax)
calls: collections.Counter = collections.Counter()
#: the seq pairs' traffic in this process, forward and backward, and the
#: MoE routing counts' gather (:func:`seq_all_gather`): ``calls``,
#: ``bytes`` (of the send buffers, the rank's own chunk included),
#: ``staged`` (tensors copied through host memory for gloo) and
#: ``seconds`` (host wall time of the exchange: on a staged call the
#: copies and the gloo call, the card synchronized first so no queued
#: kernel is counted; on NCCL the enqueue only)
seq_stats: collections.Counter = collections.Counter()
#: the expert exchange's traffic (:func:`data_all_to_all`) in this
#: process, forward, backward and a checkpointed block's recompute: the
#: same keys as ``seq_stats``
ep_stats: collections.Counter = collections.Counter()
#: 1-bit Adam's compressed momentum exchange (``compress/onebit.py``) in
#: this process: ``calls``, ``bytes`` and ``bytes_<dtype>`` (of the send
#: buffers: the packed signs as ``bytes_uint8``, the scales as
#: ``bytes_float32``), ``staged`` and ``seconds`` as in ``seq_stats``
onebit_stats: collections.Counter = collections.Counter()
#: the CSR gradients' exchange (``runtime/csr_tensor.py``): the same keys
#: (indices as ``bytes_int32``, values as ``bytes_<their dtype>``)
csr_stats: collections.Counter = collections.Counter()

#: the active :func:`recorded` logs
_logs: list = []


@contextlib.contextmanager
def recorded():
    """Log every collective that crosses ranks inside the block as
    ``(op, dtype name, elements of its result)`` in a list this yields —
    the sizes the JAX package's tests read from a compiled step's HLO
    (an all-gather's result is the gathered tensor)."""
    log: list = []
    _logs.append(log)
    try:
        yield log
    finally:
        _logs.remove(log)


def _record(op: str, out: torch.Tensor) -> None:
    for log in _logs:
        log.append((op, str(out.dtype).replace("torch.", ""), out.numel()))


def _reduce(x, mesh: Mesh, axis: str, op):
    calls["reduce"] += 1
    out = x.clone()
    g = mesh.group(axis)
    if g is not None:
        dist.all_reduce(out, op=op, group=g)
        _record("all_reduce", out)
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
    calls["all_gather"] += 1
    g = mesh.group(axis)
    x0 = x.movedim(dim, 0).contiguous()
    if g is None:
        return x0.movedim(0, dim).clone()
    n = mesh.axis_size(axis)
    out = torch.empty((n * x0.shape[0],) + tuple(x0.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x0, group=g)
    _record("all_gather", out)
    return out.movedim(0, dim).contiguous()


def reduce_scatter(x: torch.Tensor, mesh: Mesh, axis: str,
                   dim: int = 0) -> torch.Tensor:
    """Sum over the axis; each rank keeps its own 1/n of ``dim``."""
    calls["reduce_scatter"] += 1
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
    _record("reduce_scatter", out)
    return out.movedim(0, dim).contiguous()


def pbroadcast_from(x: torch.Tensor, mesh: Mesh, axis: str,
                    root: int = 0) -> torch.Tensor:
    """Axis index ``root``'s ``x`` on every rank of the axis (the others'
    ``x`` gives only shape and dtype)."""
    calls["pbroadcast_from"] += 1
    out = x.clone()
    g = mesh.group(axis)
    if g is not None:
        dist.broadcast(out, src=mesh.axis_ranks(axis)[root], group=g)
        _record("broadcast", out)
    return out


def reduce_to(x: torch.Tensor, mesh: Mesh, axis: str,
              root: int = 0) -> torch.Tensor:
    """The axis's sum on axis index ``root``; other ranks get a tensor
    whose values are unspecified."""
    calls["reduce_to"] += 1
    out = x.clone()
    g = mesh.group(axis)
    if g is not None:
        dist.reduce(out, dst=mesh.axis_ranks(axis)[root], group=g)
        _record("reduce", out)
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


# ---------------------------------------------------------------------------
# the seq axis: Ulysses' all-to-all and ring attention's rotation
# ---------------------------------------------------------------------------
def _host_staged(g, x: torch.Tensor) -> bool:
    staged = x.is_cuda and dist.get_backend(g) == "gloo"
    if staged:
        # the device-to-host copy would wait for the queued kernels
        # anyway: wait here, so ``seconds`` times the exchange alone
        torch.cuda.current_stream(x.device).synchronize()
    return staged


def _all_to_all(x, mesh: Mesh, axis: str, split_dim: int,
                concat_dim: int, stats: collections.Counter, name: str):
    """The tiled all-to-all over ``axis``, its traffic counted in
    ``stats`` (``name`` is the public function, for the error)."""
    g = mesh.group(axis)
    if g is None:
        return x.clone()
    n = mesh.axis_size(axis)
    if x.shape[split_dim] % n:
        raise ValueError(
            f"{name}: dim {split_dim} of {tuple(x.shape)} does not "
            f"divide by the {axis} axis's {n}")
    send = torch.stack(x.chunk(n, split_dim)).contiguous()
    staged = _host_staged(g, send)
    t0 = time.perf_counter()
    if staged:
        send = send.cpu()
        stats["staged"] += 1
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=g)
    _record("all_to_all", recv)
    if staged:
        recv = recv.to(x.device)
        stats["staged"] += 1
    stats["seconds"] += time.perf_counter() - t0
    stats["calls"] += 1
    stats["bytes"] += send.numel() * send.element_size()
    return torch.cat(recv.unbind(0), dim=concat_dim)


def _ring_shift(x, mesh: Mesh, step: int):
    """Send ``x`` to seq index ``i + step`` and receive from ``i - step``
    (mod n), the send and the receive posted together."""
    g = mesh.group(SEQ_AXIS)
    if g is None:
        return x.clone()
    n = mesh.axis_size(SEQ_AXIS)
    i = mesh.axis_index(SEQ_AXIS)
    ranks = mesh.axis_ranks(SEQ_AXIS)
    send = x.detach().contiguous()
    staged = _host_staged(g, send)
    t0 = time.perf_counter()
    if staged:
        send = send.cpu()
        seq_stats["staged"] += 1
    recv = torch.empty_like(send)
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, ranks[(i + step) % n], group=g),
        dist.P2POp(dist.irecv, recv, ranks[(i - step) % n], group=g)])
    for w in works:
        w.wait()
    _record("ring_shift", recv)
    if staged:
        recv = recv.to(x.device)
        seq_stats["staged"] += 1
    seq_stats["calls"] += 1
    seq_stats["bytes"] += send.numel() * send.element_size()
    seq_stats["seconds"] += time.perf_counter() - t0
    return recv


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.mesh, ctx.axis, ctx.dims = mesh, axis, (split_dim, concat_dim)
        return _all_to_all(x, mesh, axis, split_dim, concat_dim,
                           *_A2A[axis])

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return (_all_to_all(g, ctx.mesh, ctx.axis, concat_dim, split_dim,
                            *_A2A[ctx.axis]), None, None, None, None)


class _SeqRingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _ring_shift(x, mesh, 1)

    @staticmethod
    def backward(ctx, g):
        return _ring_shift(g, ctx.mesh, -1), None


def seq_all_to_all(x: torch.Tensor, mesh: Mesh, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
    """The tiled all-to-all over ``seq`` (``lax.all_to_all(x, "seq",
    split_dim, concat_dim, tiled=True)``): ``x`` splits into n chunks
    along ``split_dim``, chunk j goes to seq index j, and the chunks
    received concatenate along ``concat_dim`` in seq order."""
    return _AllToAll.apply(x, mesh, SEQ_AXIS, split_dim, concat_dim)


def seq_ring_shift(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` of seq index ``i - 1`` on seq index ``i`` (mod n) — the
    ``ppermute`` that rotates ring attention's K/V shards forward."""
    return _SeqRingShift.apply(x, mesh)


# ---------------------------------------------------------------------------
# the data axis: the expert exchange
# ---------------------------------------------------------------------------
#: each all-to-all axis's counters and the function named in its errors
_A2A = {SEQ_AXIS: (seq_stats, "seq_all_to_all"),
        DATA_AXIS: (ep_stats, "data_all_to_all")}


def data_all_to_all(x: torch.Tensor, mesh: Mesh, split_dim: int,
                    concat_dim: int) -> torch.Tensor:
    """The tiled all-to-all over ``data`` — expert parallelism's token
    exchange: ``x`` splits into dp chunks along ``split_dim`` (the expert
    dim, forward), chunk j goes to data index j, and the chunks received
    concatenate along ``concat_dim`` in data order.  Backward is the
    all-to-all with the dims swapped, so each expert's rank receives
    every data rank's contribution to its gradient.  Counted in
    ``ep_stats``."""
    return _AllToAll.apply(x, mesh, DATA_AXIS, split_dim, concat_dim)


class _SumOverAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return psum(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.mesh, ctx.axis), None, None


def sum_over_axis(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum over ``axis`` of a quantity that every rank's loss then
    takes whole (the MoE load-balance statistics over the global batch):
    all-reduced forward and backward — each rank's cotangent reaches
    every rank's summand, as it would in one program over the global
    batch (:func:`reduce_from_axis` passes only the rank's own)."""
    return _SumOverAxis.apply(x, mesh, axis)


# ---------------------------------------------------------------------------
# the data axis: compressed data parallelism (1-bit Adam, CSR gradients)
# ---------------------------------------------------------------------------
def _dtype_bytes(stats: collections.Counter, x: torch.Tensor) -> None:
    stats["bytes_" + str(x.dtype).replace("torch.", "")] += (
        x.numel() * x.element_size())


def onebit_all_to_all(x: torch.Tensor, mesh: Mesh,
                      axis: str = DATA_AXIS) -> torch.Tensor:
    """1-bit Adam's first phase (``lax.all_to_all(x, axis, 0, 0)``): row
    j of ``x [world, k]`` goes to index j of ``axis``, and row i of the
    result came from index i.  Counted in ``onebit_stats``."""
    out = _all_to_all(x, mesh, axis, 0, 0, onebit_stats,
                      "onebit_all_to_all")
    if mesh.group(axis) is not None:
        # ``_all_to_all`` counted the call and its ``bytes``
        _dtype_bytes(onebit_stats, x)
    return out


def _stacked_gather(x: torch.Tensor, mesh: Mesh, axis: str,
                    stats: collections.Counter) -> torch.Tensor:
    """``[world, *x.shape]``: every index of ``axis``'s ``x`` in axis
    order, counted in ``stats``; on gloo a CUDA tensor is staged through
    host memory."""
    g = mesh.group(axis)
    if g is None:
        return x[None].clone()
    n = mesh.axis_size(axis)
    send = x.reshape(-1).contiguous()
    staged = _host_staged(g, send)
    t0 = time.perf_counter()
    if staged:
        send = send.cpu()
        stats["staged"] += 1
    out = torch.empty(n * send.numel(), dtype=send.dtype,
                      device=send.device)
    dist.all_gather_into_tensor(out, send, group=g)
    _record("all_gather", out)
    out = out.reshape((n,) + tuple(x.shape))
    if staged:
        out = out.to(x.device)
        stats["staged"] += 1
    stats["seconds"] += time.perf_counter() - t0
    stats["calls"] += 1
    stats["bytes"] += send.numel() * send.element_size()
    return out


def data_all_gather(x: torch.Tensor, mesh: Mesh, stats: collections.Counter,
                    axis: str = DATA_AXIS) -> torch.Tensor:
    """``[world, *x.shape]``: every index of ``axis``'s ``x`` in axis order
    (``lax.all_gather``), its traffic counted in ``stats``
    (``onebit_stats`` or ``csr_stats``, with the bytes by dtype too).  On
    gloo a CUDA tensor is staged through host memory."""
    out = _stacked_gather(x, mesh, axis, stats)
    if mesh.group(axis) is not None:
        _dtype_bytes(stats, x)
    return out


def seq_all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``[sp, *x.shape]``: every seq index's ``x`` in seq order — the MoE
    layer's routing counts, which carry no gradient (the result is
    detached).  Counted in ``seq_stats``; on gloo a CUDA tensor is staged
    through host memory."""
    return _stacked_gather(x.detach(), mesh, SEQ_AXIS, seq_stats)
