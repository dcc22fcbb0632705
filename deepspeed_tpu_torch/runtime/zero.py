"""ZeRO stages 0–3 — the counterpart of ``deepspeed_tpu/runtime/zero.py``.

The JAX package states ZeRO as placement on a compiled graph and lets XLA
insert the collectives.  The port keeps the same placement rules
(:func:`shard_spec_for_leaf`, :func:`sanitize_base_spec`,
:class:`ZeroShardingPlan`; a ``PartitionSpec`` is a tuple of axis names,
or None, per dim) and runs the collectives itself
(:class:`ZeroRuntime`):

  stage 0 — master, grads and optimizer state whole on every data rank;
            the grads are all-reduced over ``data`` at the step boundary.
  stage 1 — the fp32 master and the moments sharded over ``data``; the
            grads all-reduced and each rank updates its own shard; the
            compute copy all-gathered after the update.
  stage 2 — + the grads reduce-scattered in the backward, so a rank
            accumulates only its 1/dp.
  stage 3 — + no compute copy: each block's slices are gathered inside
            the block's checkpointed function (re-gathered when the
            backward recomputes it) and their grads reduce-scattered back
            to the shard.  A slice on the stacked layer dim lives whole on
            one data rank, so its gather is a broadcast from that owner
            and its gradient a reduce onto it.

With ZeRO-Offload (``runtime/offload.py``, ``runtime/offload_xla.py``)
the master and moments live in host RAM and the sources are the uploaded
compute copy (all-gathered over ``data`` where the stage gathers it), the
forward's one place for a layer's bytes to come from as at any stage.
Two hooks serve the pinned-piece tier: ``start_grads(keep=...)`` keeps
one group of leaves' gradients (the others are fetched without autograd,
so their weight gradients are never computed), and a ``streamer``
(``offload_xla.StreamedLeaves``) holds the compute copies of the
streamed leaves in pinned host memory, fetches one layer of them per
block and takes their gradients to a pinned host stack.

A leaf whose dims do not divide stays replicated (no padding), and a
tensor-parallel dim that does not divide falls back to replication, as in
the JAX plan.  Every collective runs at every stage and every group size
(a one-rank NCCL group on the card); a local mesh runs them as one-rank
identities.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from ..parallel import collectives as col
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, mesh_axis_size
from .utils import tree_leaves

Spec = Tuple[Any, ...]


def _is_spec(x) -> bool:
    return isinstance(x, tuple)


def shard_spec_for_leaf(shape: tuple, axis_size: int,
                        axis_name: str = DATA_AXIS,
                        base_spec: Optional[Spec] = None) -> Spec:
    """Extend ``base_spec`` (e.g. a tensor-parallel spec) by sharding the
    first unassigned dim divisible by ``axis_size`` over ``axis_name``."""
    base = list(base_spec) if base_spec is not None else []
    base += [None] * (len(shape) - len(base))
    if axis_size <= 1:
        return tuple(base)

    def uses_axis(entry) -> bool:
        return (axis_name in entry if isinstance(entry, tuple)
                else entry == axis_name)
    if any(uses_axis(e) for e in base if e is not None):
        return tuple(base)
    for i, d in enumerate(shape):
        if base[i] is None and d % axis_size == 0 and d > 0:
            base[i] = axis_name
            return tuple(base)
    return tuple(base)  # too small / indivisible: replicate (no padding)


def sanitize_base_spec(spec: Optional[Spec], shape: tuple,
                       mesh: Mesh) -> Optional[Spec]:
    """Drop base-spec axis assignments whose dim does not divide by the
    axis size (the product, for tuple entries, kept greedily major to
    minor): that dim falls back to replication."""
    if spec is None:
        return None
    if len(spec) > len(shape):
        raise ValueError(
            f"partition spec {spec} has more entries than array rank "
            f"{len(shape)} (shape {shape}) — model param_partition_specs "
            "and param tree disagree")
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for i, e in enumerate(entries):
        if e is None:
            out.append(None)
            continue
        names = e if isinstance(e, tuple) else (e,)
        kept, prod = [], 1
        for n in names:
            s = mesh_axis_size(mesh, n)
            if shape[i] % (prod * s) == 0:
                kept.append(n)
                prod *= s
        if not kept:
            out.append(None)
        elif not isinstance(e, tuple):
            out.append(kept[0])
        else:
            out.append(tuple(kept))
    return tuple(out)


def _structure(tree, is_leaf):
    if not is_leaf(tree) and isinstance(tree, dict):
        return {k: _structure(v, is_leaf) for k, v in tree.items()}
    return "*"


def _leaves(tree, is_leaf) -> list:
    if not is_leaf(tree) and isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v, is_leaf)]
    return [tree]


def _map2(fn, specs, tree):
    if isinstance(tree, dict):
        return {k: _map2(fn, specs[k], v) for k, v in tree.items()}
    return fn(specs, tree)


def _rebuild(tree, leaves):
    it = iter(leaves)

    def go(t):
        if isinstance(t, dict):
            return {k: go(v) for k, v in t.items()}
        return next(it)
    return go(tree)


def _shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", ()))


class ZeroShardingPlan:
    """Per-stage placement rules for the train state (the JAX plan's)."""

    def __init__(self, stage: int, mesh: Mesh,
                 base_param_specs: Optional[Any] = None,
                 params: Optional[Any] = None):
        if not 0 <= stage <= 3:
            raise ValueError(f"ZeRO stage must be 0..3, got {stage}")
        self.stage = stage
        self.mesh = mesh
        self.dp = mesh_axis_size(mesh, DATA_AXIS)
        if base_param_specs is not None and params is not None:
            spec_def = _structure(base_param_specs, _is_spec)
            param_def = _structure(params, lambda x: not isinstance(x, dict))
            if spec_def != param_def:
                raise ValueError(
                    "param_partition_specs tree structure does not match "
                    "the param tree — every param leaf needs exactly one "
                    "PartitionSpec at the same position.\n"
                    f"  specs tree:  {spec_def}\n"
                    f"  params tree: {param_def}")
            base_param_specs = _map2(
                lambda s, leaf: sanitize_base_spec(s, _shape(leaf), mesh),
                base_param_specs, params)
        self.base_param_specs = base_param_specs

    def _specs(self, tree, sharded: bool):
        leaves = tree_leaves(tree)
        base = (None if self.base_param_specs is None
                else _leaves(self.base_param_specs, _is_spec))
        if base is not None and len(base) != len(leaves):
            raise ValueError(
                "param_partition_specs leaf count does not match the tree "
                f"being placed: {len(base)} specs vs {len(leaves)} leaves")
        specs = []
        for i, leaf in enumerate(leaves):
            b = None if base is None else base[i]
            if sharded:
                specs.append(shard_spec_for_leaf(_shape(leaf), self.dp,
                                                 DATA_AXIS, b))
            else:
                specs.append(b if b is not None else ())
        return _rebuild(tree, specs)

    def master_param_specs(self, params):
        """fp32 master copy: sharded from stage >= 1."""
        return self._specs(params, sharded=self.stage >= 1)

    def compute_param_specs(self, params):
        """Params as the forward consumes them: sharded only at stage 3."""
        return self._specs(params, sharded=self.stage >= 3)

    def grad_specs(self, params):
        """Gradients: sharded (reduce-scattered) from stage >= 2."""
        return self._specs(params, sharded=self.stage >= 2)

    def placements(self, params) -> List["LeafPlacement"]:
        """Each leaf's shape, tensor-parallel dim and ZeRO dim, in
        ``tree_leaves`` order.  The ZeRO dim is the one the stage-3 spec
        shards, chosen by the same rule at every data-axis size — at
        dp = 1 too, where the specs shard nothing, so that one rank runs
        the same slicing and collectives as many."""
        base = (None if self.base_param_specs is None
                else _leaves(self.base_param_specs, _is_spec))
        out = []
        for i, leaf in enumerate(tree_leaves(params)):
            shape = _shape(leaf)
            spec = list((base[i] if base is not None else None) or ())
            spec += [None] * (len(shape) - len(spec))
            tp_dim = zero_dim = None
            for d, e in enumerate(spec):
                if isinstance(e, tuple) or e not in (None, MODEL_AXIS):
                    raise NotImplementedError(
                        f"a base spec entry {e!r} ({tuple(spec)}) is not "
                        "ported to deepspeed_tpu_torch yet: ROADMAP.md "
                        "queue 1, item 11 (expert parallelism)")
                if e == MODEL_AXIS:
                    tp_dim = d
            for d, n in enumerate(shape):
                if spec[d] is None and n > 0 and n % self.dp == 0:
                    zero_dim = d
                    break
            out.append(LeafPlacement(shape, tp_dim, zero_dim))
        return out


class LeafPlacement(NamedTuple):
    shape: tuple                 # the whole (logical) leaf
    tp_dim: Optional[int]        # dim split over ``model``
    zero_dim: Optional[int]      # dim ZeRO splits over ``data``


class ShardPiece:
    """One rank's piece of a leaf, as the checkpoint writes and reads it:
    ``box`` is its ``[start, stop)`` per dim of the whole ``shape``, and
    ``write`` says this rank is the piece's first holder (replicas of a
    piece are written once).  A plain class, not a tuple: the checkpoint's
    tree walk must take it as one leaf."""
    __slots__ = ("tensor", "shape", "box", "write")

    def __init__(self, tensor, shape, box, write: bool):
        self.tensor, self.shape, self.box, self.write = (
            tensor, tuple(shape), tuple(box), bool(write))

    @property
    def whole(self) -> bool:
        return all(a == 0 and b == n for (a, b), n in zip(self.box,
                                                           self.shape))

    def with_tensor(self, tensor) -> "ShardPiece":
        return ShardPiece(tensor, self.shape, self.box, self.write)


class LayerStack:
    """The stacked-layer subtree as the engine hands it to the model: its
    ``layer(i)`` fetches layer ``i``'s compute params (tensor-parallel
    pieces) when the block runs, inside the block's checkpointed function,
    so the backward's recompute fetches them again.  ``mesh`` is the
    engine's mesh (the model's tensor-parallel group and data rows)."""

    def __init__(self, runtime: "ZeroRuntime", names: Dict[str, int],
                 anchor):
        self._rt = runtime
        self._names = names
        self._anchor = anchor
        self.mesh = runtime.mesh

    def layer(self, i: int) -> Dict[str, torch.Tensor]:
        return {name: self._rt.fetch(self._anchor, idx, i)
                for name, idx in self._names.items()}


class _Fetch(torch.autograd.Function):
    """A leaf's (or one layer's) compute params forward; its gradient,
    in fp32, added into the engine's accumulator backward (reduced over
    ``data`` first where the grads are sharded).  ``anchor`` is the one
    input that requires grad, so autograd runs the backward."""

    @staticmethod
    def forward(ctx, anchor, rt, idx, layer):
        ctx.rt, ctx.idx, ctx.layer = rt, idx, layer
        return rt.materialize(idx, layer)

    @staticmethod
    def backward(ctx, g):
        ctx.rt.accumulate(ctx.idx, ctx.layer, g)
        return None, None, None, None


class ZeroRuntime:
    """The stage's collectives over one engine's parameter tree.

    ``sources`` are what the forward fetches from: the master (stage 0,
    cast per fetch), the gathered compute copy (stages 1–2) or the master
    shard (stage 3, gathered per fetch).  ``stacked`` names the top-level
    key of the model's layer-stacked subtree (``model.stacked_layers``),
    fetched one layer at a time; every other leaf is fetched whole once
    per micro-step."""

    def __init__(self, plan: ZeroShardingPlan, params, compute_dtype,
                 stacked: Optional[str] = None):
        self.plan = plan
        self.mesh = plan.mesh
        self.stage = plan.stage
        self.compute_dtype = compute_dtype
        self.placements = plan.placements(params)
        self.dp = mesh_axis_size(self.mesh, DATA_AXIS)
        self.tp = mesh_axis_size(self.mesh, MODEL_AXIS)
        self.dp_rank = self.mesh.axis_index(DATA_AXIS)
        self.tp_rank = self.mesh.axis_index(MODEL_AXIS)
        self.stacked = stacked if isinstance(params, dict) and \
            isinstance(params.get(stacked), dict) else None
        self.template = _rebuild(params, range(len(self.placements)))
        self.sources: List[torch.Tensor] = []
        self._acc: Optional[List[torch.Tensor]] = None
        self._acc_sharded: List[bool] = []
        #: the leaves whose gradients this pass keeps (None: every leaf)
        self._keep: Optional[frozenset] = None
        #: the host-streamed leaves' fetcher and gradient sink, or None
        self.streamer = None
        dev = tree_leaves(params)[0].device if self.placements else None
        # leaves split over ``data`` / ``model`` in the master's placement
        # (the grads' and the update's too, once reduced): the norms sum
        # their pieces over that group
        self._data_mask = torch.tensor(
            [self.master_split(i) for i in range(len(self.placements))],
            dtype=torch.bool, device=dev)[:, None]
        self._model_mask = torch.tensor(
            [p.tp_dim is not None for p in self.placements],
            dtype=torch.bool, device=dev)[:, None]

    # -- placement -------------------------------------------------------
    def master_split(self, i: int) -> bool:
        return self.stage >= 1 and self.placements[i].zero_dim is not None

    def box(self, i: int, data: bool) -> Tuple[Tuple[int, int], ...]:
        """This rank's ``[start, stop)`` per dim of leaf ``i``: its
        tensor-parallel piece, and its data shard too when ``data``."""
        pl = self.placements[i]
        b = [(0, n) for n in pl.shape]
        if pl.tp_dim is not None:
            n = pl.shape[pl.tp_dim] // self.tp
            b[pl.tp_dim] = (self.tp_rank * n, (self.tp_rank + 1) * n)
        if data and pl.zero_dim is not None:
            n = pl.shape[pl.zero_dim] // self.dp
            b[pl.zero_dim] = (self.dp_rank * n, (self.dp_rank + 1) * n)
        return tuple(b)

    def piece(self, full: torch.Tensor, i: int, data: bool) -> torch.Tensor:
        """This rank's piece of the whole leaf ``full``."""
        return full[tuple(slice(a, b) for a, b in self.box(i, data))]

    def data_shard(self, t: torch.Tensor, i: int) -> torch.Tensor:
        """This rank's data shard of a tensor-parallel piece."""
        d = self.placements[i].zero_dim
        n = t.shape[d] // self.dp
        return t.narrow(d, self.dp_rank * n, n)

    def shard_pieces(self, leaves) -> List[ShardPiece]:
        """The master-placed ``leaves`` as checkpoint pieces."""
        out = []
        for i, t in enumerate(leaves):
            pl = self.placements[i]
            write = ((self.master_split(i) or self.dp_rank == 0)
                     and (pl.tp_dim is not None or self.tp_rank == 0))
            out.append(ShardPiece(t, pl.shape, self.box(i,
                                                        self.master_split(i)),
                                  write))
        return out

    # -- the forward's parameters -----------------------------------------
    def set_sources(self, master: List[torch.Tensor]) -> None:
        """After an update or a load: at stages 1–2 the compute copy is
        all-gathered from the master shards (in the compute dtype)."""
        if self.stage in (1, 2):
            cdt = self.compute_dtype
            self.sources = [
                col.all_gather(m.to(cdt), self.mesh, DATA_AXIS,
                               self.placements[i].zero_dim)
                if self.master_split(i) else m.to(cdt)
                for i, m in enumerate(master)]
        else:
            self.sources = list(master)

    def fetch(self, anchor, idx: int, layer: Optional[int]):
        """Leaf ``idx`` (or one layer of it) for the forward: through
        :class:`_Fetch` when its gradient is kept, else without autograd."""
        if self._keep is not None and idx not in self._keep:
            return self.materialize(idx, layer)
        return _Fetch.apply(anchor, self, idx, layer)

    def compute_tree(self, anchor):
        """The params tree the model's ``loss_fn`` takes: whole leaves
        fetched now, the stacked subtree as a :class:`LayerStack`."""
        def go(t, top):
            out = {}
            for k, v in t.items():
                if top and k == self.stacked:
                    out[k] = LayerStack(self, v, anchor)
                elif isinstance(v, dict):
                    out[k] = go(v, False)
                else:
                    out[k] = self.fetch(anchor, v, None)
            return out
        if not isinstance(self.template, dict):
            return self.fetch(anchor, self.template, None)
        return go(self.template, True)

    def streamed(self, i: int) -> bool:
        return self.streamer is not None and i in self.streamer.leaves

    def _owner(self, layer: int, i: int) -> Tuple[int, int]:
        per = self.placements[i].shape[0] // self.dp
        return layer // per, layer % per

    def materialize(self, i: int, layer: Optional[int]) -> torch.Tensor:
        pl = self.placements[i]
        src = self.sources[i]
        cdt = self.compute_dtype if src.is_floating_point() else src.dtype
        if self.streamed(i):
            # a layer of a pinned host stack: fetched on the side stream
            get = self.streamer.getter(i)
        else:
            def get(idx):
                return src if idx is None else src[idx]
        if self.stage >= 3 and pl.zero_dim is not None:
            if layer is not None and pl.zero_dim == 0:
                owner, local = self._owner(layer, i)
                x = (get(local).to(cdt) if owner == self.dp_rank else
                     torch.empty(src.shape[1:], dtype=cdt,
                                 device=self._data_mask.device))
                return col.pbroadcast_from(x, self.mesh, DATA_AXIS, owner)
            x = get(layer)
            return col.all_gather(x.to(cdt), self.mesh, DATA_AXIS,
                                  pl.zero_dim - (layer is not None))
        if self.streamed(i):
            return get(layer).to(cdt)
        x = src if layer is None else src[layer]
        # a view, never ``src`` itself: autograd would make the Function's
        # output (and so the master) require grad
        return x.to(cdt).view_as(x)

    # -- gradients --------------------------------------------------------
    def start_grads(self, sharded: bool,
                    keep: Optional[frozenset] = None) -> None:
        """Zeroed fp32 accumulators for one step: a rank's data shard
        where ``sharded`` (stages 2–3) and the leaf divides, else the
        whole tensor-parallel piece; only the ``keep`` leaves' when
        given.  A streamed leaf's accumulator is the streamer's host
        stack."""
        self._keep = keep
        self._acc_sharded = [sharded and p.zero_dim is not None
                             for p in self.placements]
        dev = self._data_mask.device
        if self.streamer is not None:
            self.streamer.start_grads(keep)
        self._acc = [
            None if (keep is not None and i not in keep)
            or self.streamed(i) else
            torch.zeros([b - a for a, b in self.box(i, s)],
                        dtype=torch.float32, device=dev)
            for i, s in enumerate(self._acc_sharded)]

    def accumulate(self, i: int, layer: Optional[int], g: torch.Tensor):
        g32 = g.float()
        pl = self.placements[i]
        idx = layer
        if self._acc_sharded[i]:
            if layer is not None and pl.zero_dim == 0:
                owner, idx = self._owner(layer, i)
                g32 = col.reduce_to(g32, self.mesh, DATA_AXIS, owner)
                if owner != self.dp_rank:
                    return
            else:
                g32 = col.reduce_scatter(g32, self.mesh, DATA_AXIS,
                                         pl.zero_dim - (layer is not None))
        if self.streamed(i):
            if not self._acc_sharded[i] and self.dp > 1:
                # no boundary all-reduce reaches a host stack: reduce
                # each layer's contribution now
                g32 = col.psum(g32, self.mesh, DATA_AXIS)
            self.streamer.accumulate(i, idx, g32)
            return
        acc = self._acc[i]
        (acc if idx is None else acc[idx]).add_(g32)

    def finish_grads(self) -> List[torch.Tensor]:
        """The step's summed grads in the master's placement: the
        accumulators not yet reduced are all-reduced over ``data`` (and
        cut to the rank's shard where the master is sharded).  A leaf
        whose gradient was not kept is None; a streamed leaf's is its
        host stack (``offload_xla.HostGrad``)."""
        out = []
        host = (self.streamer.finish_grads() if self.streamer is not None
                else {})
        for i, a in enumerate(self._acc):
            if i in host:
                a = host[i]
            elif a is not None and not self._acc_sharded[i]:
                a = col.psum(a, self.mesh, DATA_AXIS)
                if self.master_split(i):
                    a = self.data_shard(a, i)
            out.append(a)
        self._acc = None
        self._keep = None
        return out

    # -- norms over the logical tree ---------------------------------------
    def leaf_sums(self, v: torch.Tensor) -> torch.Tensor:
        """``v [n_leaves, k]``: each leaf's local sums (of squares) over
        its master-placed piece → the sums over the whole leaf, on every
        rank: summed over ``data`` for leaves split there, then over
        ``model`` for tensor-parallel leaves; a replicated leaf counts
        once."""
        dm, mm = self._data_mask, self._model_mask
        v = torch.where(dm, col.psum(torch.where(dm, v, 0.0), self.mesh,
                                     DATA_AXIS), v)
        return torch.where(mm, col.psum(torch.where(mm, v, 0.0), self.mesh,
                                        MODEL_AXIS), v)
