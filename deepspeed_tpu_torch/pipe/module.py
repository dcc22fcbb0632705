"""Declarative pipeline-parallel model description — the port of
``deepspeed_tpu/pipe/module.py``.

(reference: deepspeed/runtime/pipe/module.py:23-575 — LayerSpec lazy build,
TiedLayerSpec, partitioning by parameters/uniform/type:regex.)

A PipelineModule is a *declaration*: an ordered list of layer specs plus a
partitioning policy.  Stage assignment is pure math
(``parallel/partition.py``); execution lives in ``pipe/engine.py``, which
runs each stage in its own process and crosses the stage boundaries with
``torch.distributed`` point-to-point calls (``pipe/p2p.py``).

Layer contract (functional, as the port's models): each built layer is an
object with ``init(seed, device=None) -> params`` (a dict of tensors, or
None for a stateless layer) and ``apply(params, x, rng, train=True,
mesh=None) -> x``; ``rng`` is a host integer seed
(``runtime/module.py``) and ``mesh`` the engine's rank mesh (tensor
parallelism and the data rows the dropouts draw over).  A layer may also
define ``param_shapes() -> {name: (shape, dtype)}`` (the partitioner and
the stack fingerprints then never build its tensors) and
``param_partition_specs()`` (its Megatron placement on ``model``).

The parameter tree is the JAX module's packed tree, key for key:
``stack_<n>`` holds ``[S, k, ...]`` leaves of the layers that repeat with
one fingerprint on every stage, ``layer_<i>`` a resident layer's params
and ``tied/<key>`` a tied layer's.  A pipe rank holds its stage's rows of
each stack (the ``[k, ...]`` local view, the JAX engine's shard_map-local
view) and every other leaf whole.  :func:`carry_params` restacks a packed
tree of one pipeline depth into another's (JAX ``init`` trees included,
as numpy arrays).
"""
from __future__ import annotations

import re
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..parallel.partition import partition_balanced, partition_uniform
from ..runtime.utils import fold_in
from ..utils.logging import logger


class LayerSpec:
    """Lazily-built layer (reference: pipe/module.py:23-68): stores the
    constructor + args so each stage materializes only its own layers."""

    def __init__(self, typename: Callable, *args, **kwargs):
        self.typename = typename
        self.args = args
        self.kwargs = kwargs

    def build(self):
        return self.typename(*self.args, **self.kwargs)

    @property
    def name(self) -> str:
        return getattr(self.typename, "__name__", str(self.typename))

    def __repr__(self):
        return f"LayerSpec({self.name})"


class TiedLayerSpec(LayerSpec):
    """A layer whose params are shared with every other TiedLayerSpec of the
    same key (reference: pipe/module.py:71-82).  The tied params live once
    in the param tree under ``tied/<key>``, replicated over ``pipe``, and
    every tied layer reads them; their gradient is summed over the pipe
    group (the reference's tied-group allreduce, pipe/module.py:405-418)."""

    def __init__(self, key: str, typename: Callable, *args,
                 forward_fn: Optional[Callable] = None, **kwargs):
        super().__init__(typename, *args, **kwargs)
        self.key = key
        self.forward_fn = forward_fn


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    return [tree]


def _structure(tree) -> str:
    if isinstance(tree, dict):
        return "{" + ",".join(f"{k}:{_structure(tree[k])}"
                              for k in sorted(tree)) + "}"
    return "*"


def _sorted(tree):
    """The tree with every dict's keys in sorted order (the JAX tree's
    leaf order, which the checkpoint's ``leaf_NNNNN`` names follow)."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def _stack(xs):
    if isinstance(xs[0], torch.Tensor):
        return torch.stack(xs)
    return np.stack([np.asarray(x) for x in xs])


def _stack_trees(trees):
    return _tree_map_n(_stack, trees)


def _tree_map_n(fn, trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map_n(fn, [t[k] for t in trees]) for k in first}
    return fn(trees)


class StageView:
    """The params one stage's layers read, by the JAX view's keys
    (``layer_<i>``, ``tied``): a resident or tied entry is taken from the
    packed tree as it is, a stacked layer's row when it is read — from a
    tensor leaf by index, or from the engine's layer fetcher
    (``runtime.zero.LayerStack``, inside the stage's checkpointed
    function, so a recompute fetches it again)."""

    def __init__(self, module: "PipelineModule", params, stage: int,
                 local: bool):
        self._params = params
        self._stage = stage
        self._local = local
        self._rows: Dict[int, Tuple[str, int]] = {}
        for name, stages in module.stack_plan().items():
            for j, i in enumerate(stages[stage]):
                self._rows[i] = (name, j)

    def get(self, key, default=None):
        if key == "tied":
            return self._params.get("tied", default)
        if key in self._params:
            return self._params[key]
        i = int(key[len("layer_"):]) if key.startswith("layer_") else None
        if i is None or i not in self._rows:
            return default
        name, j = self._rows[i]
        src = self._params[name]
        fetch = getattr(src, "layer", None)
        if fetch is not None:
            return fetch(j)
        if self._local:
            return _tree_map(lambda a: a[j], src)
        return _tree_map(lambda a: a[self._stage, j], src)

    def __getitem__(self, key):
        v = self.get(key)
        if v is None:
            raise KeyError(key)
        return v

    def __contains__(self, key):
        return self.get(key) is not None


class PipelineModule:
    """Ordered layer list + stage partitioning.

    partition_method (reference: pipe/module.py:348-403):
      - 'uniform'          — equal layer counts
      - 'parameters'       — balance by parameter count
      - 'type:<regex>'     — balance count of layers whose class name matches

    ``seq_parallel``: its layers take a seq rank's token shard (set by a
    builder whose blocks attend across the shards, such as
    ``models.gpt2_pipe.build_gpt2_pipe`` with ring or Ulysses attention);
    the engine refuses a seq axis otherwise.
    """

    seq_parallel = False

    def __init__(self,
                 layers: Sequence[LayerSpec],
                 num_stages: int,
                 loss_fn: Optional[Callable] = None,
                 partition_method: str = "parameters",
                 activation_checkpoint_interval: int = 0,
                 seed_layers: bool = False,
                 base_seed: int = 1234,
                 stage_remat: Optional[bool] = None):
        self.specs: List[LayerSpec] = list(layers)
        for s in self.specs:
            if not isinstance(s, LayerSpec):
                raise TypeError(f"layers must be LayerSpec, got {type(s)}")
        self.num_stages = num_stages
        self.loss_fn = loss_fn
        self.partition_method = partition_method
        self.activation_checkpoint_interval = activation_checkpoint_interval
        # Whole-stage rematerialization per micro-batch (engine-consumed):
        # a stage keeps only its boundary input per micro-batch and
        # recomputes its body in the backward — the reference's 1F1B
        # buffer bound min(stages - stage_id + 1, micro_batches)
        # (reference: runtime/pipe/schedule.py:243-247).  None → on unless
        # the user asked for finer-grained checkpointing via
        # activation_checkpoint_interval.
        self.stage_remat = (stage_remat if stage_remat is not None
                            else activation_checkpoint_interval == 0)
        self.seed_layers = seed_layers
        self.base_seed = base_seed
        self._built_layers: Optional[List[Any]] = None
        self._structs: Dict[int, Any] = {}
        self.parts = self._partition_layers()
        self._stack_plan: Optional[Dict[str, List[List[int]]]] = None
        self._stack_index: Optional[Dict[int, Tuple[str, int, int]]] = None

    def with_stages(self, num_stages: int) -> "PipelineModule":
        """The same declaration partitioned over ``num_stages``."""
        out = PipelineModule(
            self.specs, num_stages, loss_fn=self.loss_fn,
            partition_method=self.partition_method,
            activation_checkpoint_interval=(
                self.activation_checkpoint_interval),
            seed_layers=self.seed_layers, base_seed=self.base_seed,
            stage_remat=self.stage_remat)
        out.seq_parallel = self.seq_parallel
        return out

    # ----- partitioning (pure math, testable without devices) -----
    def _layer_struct(self, i: int):
        """Layer ``i``'s ``{name: (shape, dtype)}`` tree (None: no
        params): from ``param_shapes()`` when the layer has it, else from
        one initialization of that one layer on the CPU."""
        if i not in self._structs:
            layer = self.build_layers()[i]
            st = None
            shapes = getattr(layer, "param_shapes", None)
            if shapes is not None:
                st = _tree_map(lambda sd: (tuple(sd[0]), str(sd[1])),
                               shapes())
            elif hasattr(layer, "init"):
                try:
                    p = layer.init(0)
                except Exception:
                    p = None
                if p is not None:
                    st = _tree_map(lambda a: (tuple(a.shape), str(a.dtype)),
                                   p)
            self._structs[i] = st
        return self._structs[i]

    def _count_layer_params(self, i: int) -> int:
        layer = self.build_layers()[i]
        if hasattr(layer, "param_count"):
            return max(int(layer.param_count()), 1)
        st = self._layer_struct(i)
        if st is None:
            return 1
        return max(sum(int(np.prod(s)) for s, _ in _tree_leaves(st)), 1)

    def _partition_layers(self) -> List[int]:
        n = len(self.specs)
        method = self.partition_method.lower()
        if method == "uniform":
            parts = partition_uniform(n, self.num_stages)
        elif method == "parameters":
            weights = [self._count_layer_params(i) for i in range(n)]
            parts = partition_balanced(weights, self.num_stages)
        elif method.startswith("type:"):
            pat = method[len("type:"):]
            weights = [1 if re.search(pat, s.name, re.IGNORECASE) else 0
                       for s in self.specs]
            # avoid empty-weight degenerate case
            if sum(weights) == 0:
                weights = [1] * n
            parts = partition_balanced(weights, self.num_stages)
        else:
            raise ValueError(
                f"Unknown partition_method {self.partition_method!r}")
        logger.info("PipelineModule partitions: %s", parts)
        return parts

    def stage_layer_range(self, stage_id: int):
        return self.parts[stage_id], self.parts[stage_id + 1]

    # ----- build + functional forward -----
    def build_layers(self) -> List[Any]:
        if self._built_layers is None:
            self._built_layers = [s.build() for s in self.specs]
        return self._built_layers

    def tied_keys(self) -> List[str]:
        seen = []
        for s in self.specs:
            if isinstance(s, TiedLayerSpec) and s.key not in seen:
                seen.append(s.key)
        return seen

    # ----- stage-local parameter placement ---------------------------
    # The reference materializes only each stage's own layers per rank
    # (reference: runtime/pipe/module.py:197-249, partitioning :348-403).
    # Layers whose param trees are structurally identical across ALL
    # stages (the homogeneous transformer blocks that dominate param
    # bytes) are STACKED into [num_stages, k, ...] leaves, of which each
    # pipe rank holds its own stage's rows.  Non-uniform layers
    # (embedding, final norm, tied heads) stay replicated over ``pipe``.
    def _layer_param_struct(self, i: int):
        if isinstance(self.specs[i], TiedLayerSpec):
            return None
        return self._layer_struct(i)

    def stack_plan(self) -> Dict[str, List[List[int]]]:
        """{stack_name: per-stage lists of layer indices}; a stack exists
        when every stage holds the same count >= 1 of layers with an
        identical param-tree fingerprint (structure + shapes + dtypes)."""
        if self._stack_plan is not None:
            return self._stack_plan
        plan: Dict[str, List[List[int]]] = {}
        if self.num_stages > 1:
            fps: Dict[int, tuple] = {}
            for i, spec in enumerate(self.specs):
                st = self._layer_param_struct(i)
                if st is None:
                    continue
                fps[i] = (spec.name, _structure(st),
                          tuple(_tree_leaves(st)))
            per_stage = []
            for s in range(self.num_stages):
                start, stop = self.stage_layer_range(s)
                d = defaultdict(list)
                for i in range(start, stop):
                    if i in fps:
                        d[fps[i]].append(i)
                per_stage.append(d)
            seen = set()
            for i in sorted(fps):
                key = fps[i]
                if key in seen:
                    continue
                seen.add(key)
                counts = [len(ps.get(key, [])) for ps in per_stage]
                if counts[0] >= 1 and all(c == counts[0] for c in counts):
                    plan[f"stack_{len(plan)}"] = [ps[key] for ps in per_stage]
        self._stack_plan = plan
        self._stack_index = {}
        for name, stages in plan.items():
            for s, idxs in enumerate(stages):
                for j, i in enumerate(idxs):
                    self._stack_index[i] = (name, s, j)
        return plan

    def stack_index(self) -> Dict[int, Tuple[str, int, int]]:
        """layer index -> (stack_name, stage, slot-within-stage)."""
        self.stack_plan()
        return self._stack_index

    def stage_view(self, params, stage: int, local: bool = False):
        """Per-stage view {'layer_<i>': ..., 'tied': ...} of a packed
        param tree (a :class:`StageView`, read lazily).  ``local=False``
        indexes global [S, k, ...] stacked leaves; ``local=True`` expects
        the stage's own [k, ...] rows (a pipe rank's tree)."""
        return StageView(self, params, stage, local)

    def replicated_view(self, params):
        """The pipe-replicated subset (tied + resident layers) — the only
        params a 3-ary pipeline loss head may read."""
        plan = self.stack_plan()
        return {k: v for k, v in params.items() if k not in plan}

    def _init_layer(self, i: int, seed: int, device):
        layer = self.build_layers()[i]
        if not hasattr(layer, "init"):
            return None
        lseed = (fold_in(self.base_seed, i) if self.seed_layers
                 else fold_in(seed, i))
        return layer.init(lseed, device=device)

    def init(self, seed: int, device=None, stage: Optional[int] = None):
        """Init the layers' params, packed for stage-local placement:
        {'stack_<n>': stacked leaves, 'layer_<i>': resident, 'tied':
        {key: ...}}, keys sorted.  ``stage=None``: the whole tree
        ([S, k, ...] stacks); ``stage=s``: pipe rank ``s``'s tree (its
        [k, ...] rows of each stack — no other stage's stacked layer is
        built).  Tied specs initialize once (first occurrence owns the
        params).  Layer ``i`` draws from ``fold_in(seed, i)`` (or
        ``fold_in(base_seed, i)`` under ``seed_layers``), so every depth
        gives a layer the same numbers."""
        plan = self.stack_plan()
        stacked = self.stack_index()
        params, tied = {}, {}
        for i, spec in enumerate(self.specs):
            if isinstance(spec, TiedLayerSpec):
                if spec.key not in tied:
                    tied[spec.key] = self._init_layer(i, seed, device)
                continue
            if i in stacked and stage is not None \
                    and stacked[i][1] != stage:
                continue
            p = self._init_layer(i, seed, device)
            if p is not None:
                params[f"layer_{i}"] = p
        for name, stages in plan.items():
            if stage is None:
                rows = [_stack_trees([params.pop(f"layer_{i}")
                                      for i in idxs]) for idxs in stages]
                params[name] = _stack_trees(rows)
            else:
                params[name] = _stack_trees([params.pop(f"layer_{i}")
                                             for i in stages[stage]])
        if tied:
            params["tied"] = tied
        return _sorted(params)

    def local_tree(self, params, stage: int):
        """Pipe rank ``stage``'s tree of a whole packed tree (each stack's
        ``[stage]`` rows; every other leaf as it is)."""
        plan = self.stack_plan()
        return {k: (_tree_map(lambda a: a[stage], v) if k in plan else v)
                for k, v in params.items()}

    def unpack(self, params) -> Dict[str, Any]:
        """A whole packed tree → ``{'layer_<i>': params, 'tied': ...}``,
        one entry per parameterized layer."""
        out = {}
        for k, v in params.items():
            if k == "tied" or k.startswith("layer_"):
                out[k] = v
        for name, stages in self.stack_plan().items():
            src = params[name]
            for s, idxs in enumerate(stages):
                for j, i in enumerate(idxs):
                    out[f"layer_{i}"] = _tree_map(
                        lambda a, s=s, j=j: a[s][j], src)
        return out

    def pack(self, layers: Dict[str, Any]):
        """The inverse of :meth:`unpack`: per-layer params → this
        module's whole packed tree (keys sorted)."""
        params = dict(layers)
        for name, stages in self.stack_plan().items():
            rows = [_stack_trees([params.pop(f"layer_{i}") for i in idxs])
                    for idxs in stages]
            params[name] = _stack_trees(rows)
        return _sorted(params)

    def param_partition_specs(self, params):
        """Placement of a pipe rank's tree: a layer class may define
        ``param_partition_specs()`` returning a spec tree for its own
        params (Megatron column/row splits); everything else replicates.
        A stack's local ``[k, ...]`` leaves take ``(None, *layer_spec)``
        (the JAX spec ``P('pipe', None, *layer_spec)`` minus the stage
        dim, which the pipe rank holds one row of); ZeRO composes
        ``data`` on a remaining dim."""
        layers = self.build_layers()
        plan = self.stack_plan()

        def replicated(tree):
            return _tree_map(lambda _: (), tree)

        specs = {}
        tied_specs = {}
        for i, (spec, layer) in enumerate(zip(self.specs, layers)):
            get = getattr(layer, "param_partition_specs", None)
            if isinstance(spec, TiedLayerSpec):
                if spec.key not in tied_specs and spec.key in params.get(
                        "tied", {}):
                    tied_specs[spec.key] = (
                        get() if get is not None
                        else replicated(params["tied"][spec.key]))
            elif f"layer_{i}" in params:
                specs[f"layer_{i}"] = (
                    get() if get is not None
                    else replicated(params[f"layer_{i}"]))
        for name, stages in plan.items():
            layer = layers[stages[0][0]]
            get = getattr(layer, "param_partition_specs", None)
            base = get() if get is not None else replicated(params[name])
            specs[name] = _tree_map(lambda p: (None,) + tuple(p), base)
        if tied_specs:
            specs["tied"] = tied_specs
        return _sorted(specs)

    def apply_layer(self, i: int, params, x, rng, train: bool = True,
                    mesh=None):
        spec = self.specs[i]
        layer = self.build_layers()[i]
        lrng = fold_in(rng, i)
        kw = {} if mesh is None else {"mesh": mesh}
        if isinstance(spec, TiedLayerSpec):
            p = params["tied"][spec.key]
            fn = spec.forward_fn
            if fn is not None:
                return fn(layer, p, x, lrng, train)
            return layer.apply(p, x, lrng, train, **kw)
        p = params.get(f"layer_{i}")
        if p is None and i in self.stack_index():
            # packed global tree: index the stacked leaf
            name, s, j = self.stack_index()[i]
            if name in params:
                p = _tree_map(lambda a: a[s][j], params[name])
        if p is None:
            # stateless layer (e.g. reshape/activation)
            if hasattr(layer, "apply"):
                return layer.apply(None, x, lrng, train, **kw)
            return layer(x)
        return layer.apply(p, x, lrng, train, **kw)

    def forward_range(self, params, x, rng, start: int, stop: int,
                      train: bool = True, mesh=None):
        """Run layers [start, stop), with ``torch.utils.checkpoint`` every
        activation_checkpoint_interval layers when grads are on
        (reference: pipe/module.py:292-346)."""
        interval = self.activation_checkpoint_interval
        if interval and interval > 0 and torch.is_grad_enabled():
            i = start
            while i < stop:
                j = min(i + interval, stop)

                def chunk(y, i=i, j=j):
                    for k in range(i, j):
                        y = self.apply_layer(k, params, y, rng, train, mesh)
                    return y
                x = checkpoint(chunk, x, use_reentrant=False,
                               preserve_rng_state=False)
                i = j
        else:
            for i in range(start, stop):
                x = self.apply_layer(i, params, x, rng, train, mesh)
        return x

    def forward(self, params, x, rng, train: bool = True, mesh=None):
        return self.forward_range(params, x, rng, 0, len(self.specs), train,
                                  mesh)


def stack_stages(params) -> Optional[int]:
    """The pipeline depth a packed tree was stacked for: its stacks'
    leading dim, None for a tree without stacks (every depth whose
    module stacks nothing packs it the same way)."""
    for k, v in params.items():
        if k.startswith("stack_"):
            return int(_tree_leaves(v)[0].shape[0])
    return None


def carry_params(params, module: PipelineModule,
                 src_stages: Optional[int] = None):
    """A whole packed tree of ``module``'s layers at another pipeline
    depth (a JAX ``PipelineModule.init`` tree as numpy arrays, or a port
    tree) → ``module``'s whole packed tree: every layer's params found
    by its global index and restacked ``[S, k] → [S', k']`` in layer
    order, as a checkpoint restored at another pp is.  ``src_stages``:
    the depth ``params`` was packed at (default: read from its stacks)."""
    if src_stages is None:
        src_stages = stack_stages(params) or 1
    src = (module if src_stages == module.num_stages
           else module.with_stages(src_stages))
    return module.pack(src.unpack(params))
