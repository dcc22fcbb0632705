"""Pipeline-parallel engine — the port of ``deepspeed_tpu/pipe/engine.py``.

The JAX engine traces the whole pipeline as one SPMD program (a
``shard_map`` over ``pipe``, a scan over ticks, one ``ppermute`` a tick,
the backward from AD or hand-scheduled ``jax.vjp``s).  PyTorch has no
such program; its idiom is the one the JAX schedules were written to
document (``pipe/schedule.py``; reference: deepspeed/runtime/pipe/
engine.py:1131-1157): each process runs the instruction stream of its
own stage, one step after another —

  - ``LoadMicroBatch``: the first stage reads micro-batch ``m``'s inputs,
    the last stage its labels;
  - ``ForwardPass``/``BackwardPass``: autograd over the stage's layers
    (``PipelineModule.forward_range``), the last stage's loss head
    included; with ``stage_remat`` the stage body runs under
    ``torch.utils.checkpoint``, so a stage keeps only its boundary input
    per micro-batch and recomputes the body in the backward;
  - ``SendActivation``/``RecvActivation``/``SendGrad``/``RecvGrad``: the
    boundary tensors on the pipe group (``pipe/p2p.py``), a step's sends
    and receives posted together, a receive waited on only where an
    instruction consumes it;
  - ``ReduceTiedGrads``/``ReduceGrads``/``OptimizerStep``: the engine's
    update (``runtime/engine.py``) — the data reduction, the sums of the
    pipe-replicated leaves' gradients over ``pipe`` (``runtime/zero.py``),
    the norm over the logical leaves, clipping and the optimizer.

Schedules: ``"1f1b"`` (the default) interprets ``TrainSchedule``;
``"gpipe"`` runs every forward first, then every backward
(``GPipeSchedule``); ``"1f1b_uniform"`` is accepted and runs the 1F1B
interpreter: per-rank instruction streams have none of the SPMD
divergence (a seq-axis collective inside a ``lax.cond`` branch) that made
the JAX engine need a uniform-tick schedule.  ``eval_batch`` interprets
``InferenceSchedule``.

Sequence parallelism runs inside a stage: on a mesh with a ``seq`` axis
of sp > 1 every rank of a stage's seq group runs the same instruction
stream, and stage s's seq index j sends its token shard to stage s+1's
seq index j (the pipe group joins ranks that differ only in ``pipe``).
``_split`` gives each rank its shard ``[j·T/sp, (j+1)·T/sp)`` of the
inputs' and the labels' token dim (the pair is shifted already,
``split_gpt2_batch``).  The JAX engine's rules hold: ``"1f1b"`` becomes
``"1f1b_uniform"`` (logged), and a partition whose stages do not run the
same stacked rows raises at the first step.

Placement is the JAX engine's, so trees and checkpoints match: a pipe
rank holds its stage's rows of each ``stack_<n>`` leaf and every other
leaf (``layer_<i>``, ``tied``) whole; ZeRO shards over ``data`` on a
non-stage dim (``runtime/zero.py``).  Gradients accumulate in fp32 over
the micro-batches; parameters enter each stage body in the compute
dtype.  Micro-batch ``m`` is rows ``[m·B/M, (m+1)·B/M)`` of the global
batch, split again over ``data``; every rank is given the whole
``(inputs, labels)`` pair.  Seeds: the step's ``fold_in(step_rng, 0)``,
micro-batch ``m``'s ``fold_in(·, m)``, layer ``i``'s ``fold_in(·, i)``
with ``i`` the global layer index — so the dropout masks do not depend on
pp, dp, tp or the schedule.  The loss is the mean of the micro-batch
losses, summed over ``pipe`` (only the last stage's is non-zero) and
averaged over ``data``: every rank's ``train_batch`` returns it.
"""
from __future__ import annotations

import inspect
import json
import os
import re
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..parallel import collectives as col
from ..parallel.distributed import is_initialized
from ..parallel.mesh import (DATA_AXIS, PIPE_AXIS, SEQ_AXIS, build_mesh,
                             mesh_axis_size, single_device_mesh)
from ..runtime import precision
from ..runtime.dataloader import DeepSpeedDataLoader
from ..runtime.engine import (DeepSpeedEngine, _tree_map, _unflatten_like,
                              check_mesh)
from ..runtime.prefetch import DevicePlacedBatch
from ..runtime.utils import fold_in, tree_leaves
from ..runtime.zero import ShardPiece
from ..utils.logging import log_dist
from .module import PipelineModule, TiedLayerSpec, carry_params
from .p2p import PipeChannel
from .schedule import (BackwardPass, ForwardPass, GPipeSchedule,
                       InferenceSchedule, RecvActivation, RecvGrad,
                       SendActivation, SendGrad, TrainSchedule)

SCHEDULES = ("1f1b", "1f1b_uniform", "gpipe")


class _ReplicatedParamsView(dict):
    """Params visible to a 3-ary pipeline loss head: the pipe-replicated
    ones.  Reading a stage-local (stacked) layer fails here with a real
    explanation instead of a bare KeyError.  ``mesh`` is the engine's
    mesh (the head's tensor-parallel group and data rows)."""

    mesh = None

    def __missing__(self, key):
        raise KeyError(
            f"pipeline loss head tried to read param {key!r}, which is "
            "stage-local (stacked over the pipe axis). A 3-ary loss head "
            "runs on every stage and may only read pipe-replicated params: "
            f"tied layers or non-stacked resident layers ({list(self)}). "
            "Make the layer a TiedLayerSpec or compute the loss inside the "
            "last stage's layers instead.")


def _loss_arity(loss_fn) -> int:
    """Required positional parameters of ``loss_fn`` (``def mse(o, l,
    eps=1e-8)`` stays 2-ary)."""
    try:
        sig = inspect.signature(loss_fn)
    except (TypeError, ValueError):
        return 2
    return sum(1 for p in sig.parameters.values()
               if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
               and p.default is p.empty)


class _StageModule:
    """A pipe rank's stage as the engine's model: its tree (the stage's
    stack rows, every replicated leaf), its placement, and the stacked
    keys the ZeRO runtime fetches one layer at a time."""

    def __init__(self, pm: PipelineModule, stage: int):
        self.pm = pm
        self.stage = stage
        #: fetched one layer at a time (``runtime.zero.LayerStack``);
        #: they hold this pipe rank's stage rows
        self.stacked_layers = tuple(pm.stack_plan())
        self.pipelined = True
        self.seq_parallel = pm.seq_parallel

    def init(self, seed: int, device=None):
        return self.pm.init(seed, device=device, stage=self.stage)

    def param_partition_specs(self, params):
        return self.pm.param_partition_specs(params)


def _meta_params(pm: PipelineModule, dtype: torch.dtype):
    """Every layer's params as meta tensors (floating ones in ``dtype``),
    unpacked: the boundary check's shapes, no storage."""
    def meta(sd):
        shape, dt = sd
        t = getattr(torch, dt.split(".")[-1])
        if t.is_floating_point:
            t = dtype
        return torch.empty(shape, dtype=t, device="meta")

    def tree(st):
        if isinstance(st, dict):
            return {k: tree(v) for k, v in st.items()}
        return meta(st)

    out, tied = {}, {}
    for i, spec in enumerate(pm.specs):
        st = pm._layer_struct(i)
        if st is None:
            continue
        if isinstance(spec, TiedLayerSpec):
            tied.setdefault(spec.key, tree(st))
        else:
            out[f"layer_{i}"] = tree(st)
    if tied:
        out["tied"] = tied
    return out


class PipelineEngine(DeepSpeedEngine):
    """DeepSpeedEngine whose step interprets this rank's stage schedule.

    (reference: deepspeed/runtime/pipe/engine.py:45 — also a subclass of
    the core engine, inheriting optimizer/precision/checkpoint machinery.)
    """

    def __init__(self, model: PipelineModule, config, mesh=None,
                 optimizer=None, lr_schedule=None, training_data=None,
                 collate_fn=None, seed: int = 0, params=None,
                 schedule: Optional[str] = None, device=None):
        if not isinstance(model, PipelineModule):
            raise TypeError("PipelineEngine requires a PipelineModule")
        if schedule is None:
            schedule = getattr(
                getattr(config, "pipeline_config", None), "schedule",
                "1f1b")
        if schedule not in SCHEDULES:
            raise ValueError(
                f"pipeline schedule must be '1f1b', '1f1b_uniform', or "
                f"'gpipe', got {schedule!r}")
        if mesh is None:
            mesh = (build_mesh(pp=model.num_stages) if is_initialized()
                    else single_device_mesh())
        check_mesh(mesh)
        if schedule == "1f1b" and mesh_axis_size(mesh, SEQ_AXIS) > 1:
            # the JAX engine's rule: its cond-based 1F1B would run the
            # seq collectives on only some pipe ranks (this interpreter
            # would not, but the port keeps the JAX engine's schedules)
            log_dist(
                "pipeline: seq axis > 1 — using the uniform-tick 1F1B "
                "schedule (F+B units run masked every tick, so the seq "
                "collectives are schedule-invariant)", ranks=[0])
            schedule = "1f1b_uniform"
        pp = mesh_axis_size(mesh, PIPE_AXIS)
        if pp != model.num_stages:
            raise ValueError(
                f"mesh pipe axis ({pp}) != PipelineModule.num_stages "
                f"({model.num_stages})")
        if getattr(config.zero_config, "cpu_offload", False):
            # the offload tiers flatten the master into dp-sharded
            # pieces, a layout the pipe-local stacks do not fit (the JAX
            # engine's refusal)
            raise ValueError(
                "cpu_offload × pipeline parallelism is not supported: "
                "use ZeRO-3 with the pipeline engine (stage-local + "
                "data-sharded state), or the plain engine's offload/"
                "param_streaming capacity stack")
        if model.loss_fn is None:
            raise ValueError("PipelineModule needs loss_fn for training")
        self.pipeline_module = model
        self.schedule = schedule
        self.num_stages = model.num_stages
        self.stage_id = mesh.axis_index(PIPE_AXIS)
        self.micro_batches = config.gradient_accumulation_steps
        if params is not None:
            # any depth's whole packed tree (a JAX init tree as numpy
            # arrays included) → this rank's
            params = model.local_tree(carry_params(params, model),
                                      self.stage_id)
        self._loss_takes_params = _loss_arity(model.loss_fn) >= 3
        self._boundaries: Dict[Any, tuple] = {}
        self._load_layout: Optional[PipelineModule] = None
        super().__init__(_StageModule(model, self.stage_id), config,
                         optimizer=optimizer, lr_schedule=lr_schedule,
                         params=params, seed=seed,
                         training_data=training_data,
                         collate_fn=collate_fn, device=device, mesh=mesh)
        self.channel = PipeChannel(self.mesh, self.device)
        # the pipe group's first call joins every stage: NCCL leaves a
        # first point-to-point call that only some ranks make undefined
        col.psum(torch.zeros((), device=self.device), self.mesh, PIPE_AXIS)
        #: the most boundary inputs this rank held at once in the last
        #: interpreted schedule (``TrainSchedule.num_pipe_buffers()`` at
        #: most under 1F1B, whatever the micro-batch count)
        self.max_live_boundaries = 0
        log_dist(
            f"PipelineEngine: stages={self.num_stages} "
            f"micro_batches={self.micro_batches} parts={model.parts} "
            f"schedule={schedule}", ranks=[0])

    # ------------------------------------------------------------------
    # the batch contract
    # ------------------------------------------------------------------
    @property
    def is_first_stage(self) -> bool:
        return self.stage_id == 0

    @property
    def is_last_stage(self) -> bool:
        return self.stage_id == self.num_stages - 1

    def deepspeed_io(self, dataset, batch_size=None, collate_fn=None):
        """A loader of whole global batches: every pipe rank is given the
        ``(inputs, labels)`` pair and takes its own rows."""
        return DeepSpeedDataLoader(
            dataset, batch_size=batch_size or self.train_batch_size,
            collate_fn=collate_fn)

    def _split(self, tree, n: int, need: bool, what: str):
        """``[n, ...]`` leaves → this data rank's ``[M, n/(M·dp), ...]``
        rows on the device (under a seq axis, of dim 1 only the rank's
        token shard); where this stage does not read them, meta tensors
        of that shape (the boundary check's input signature)."""
        M, dp = self.micro_batches, self.dp_world_size
        d = self.mesh.axis_index(DATA_AXIS)
        sp, j = self.sp_world_size, self.mesh.axis_index(SEQ_AXIS)

        def place(x):
            t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
                np.asarray(x))
            if t.shape[0] != n:
                raise ValueError(f"{what} dim {t.shape[0]} != {n}")
            if (n // M) % dp:
                raise ValueError(
                    f"micro-batch rows {n // M} do not divide over the "
                    f"data axis ({dp})")
            mb = n // M // dp
            if sp > 1:
                if t.ndim < 2 or t.shape[1] % sp:
                    raise ValueError(
                        f"{what} leaf {tuple(t.shape)}: its token dim 1 "
                        f"does not divide by the seq axis ({sp})")
                per = t.shape[1] // sp
                t = t.narrow(1, j * per, per)
            if not need:
                return torch.empty((M, mb) + tuple(t.shape[1:]),
                                   dtype=t.dtype, device="meta")
            t = t.reshape((M, n // M) + tuple(t.shape[1:]))
            return t[:, d * mb:(d + 1) * mb].to(self.device,
                                                 non_blocking=True)
        return _tree_map(place, tree)

    def _place_train_batch(self, batch):
        if not (isinstance(batch, (tuple, list)) and len(batch) == 2):
            raise ValueError("pipeline batch must be a (inputs, labels) pair")
        inputs, labels = batch
        B = int(self.train_batch_size)
        for x in tree_leaves(inputs) + tree_leaves(labels):
            if x.shape[0] != B:
                raise ValueError(
                    f"batch dim {x.shape[0]} != train_batch_size {B}")
        return (self._split(inputs, B, self.is_first_stage, "batch"),
                self._split(labels, B, self.is_last_stage, "batch"))

    # ------------------------------------------------------------------
    # boundaries
    # ------------------------------------------------------------------
    def _boundary(self, inputs_micro) -> tuple:
        """(shape, dtype) of the stage-boundary activation for this input
        signature: every stage's output computed once on meta tensors
        (no storage, no collective) and required to agree — the JAX
        engine's ``_boundary_struct``, so receive buffers are allocated
        without a shape handshake."""
        key = tuple((tuple(x.shape), x.dtype)
                    for x in tree_leaves(inputs_micro))
        if key in self._boundaries:
            return self._boundaries[key]
        pm = self.pipeline_module
        params = _meta_params(pm, self.compute_dtype)
        x = _tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                            device="meta"), inputs_micro)
        structs = []
        for s in range(self.num_stages):
            start, stop = pm.stage_layer_range(s)
            try:
                with torch.no_grad():
                    x = pm.forward_range(params, x, 0, start, stop,
                                         train=False)
            except Exception as e:
                raise ValueError(
                    f"pipeline stage {s} (layers [{start},{stop})) cannot "
                    f"consume the previous stage's boundary activation — "
                    f"stage boundaries must share one shape: {e}") from e
            structs.append((tuple(x.shape), x.dtype))
        first = structs[0]
        for i, st in enumerate(structs):
            if st != first:
                raise ValueError(
                    "pipeline stage boundaries must share one activation "
                    f"shape; stage {i} output is {st[0]}/{st[1]} vs "
                    f"{first[0]}/{first[1]} — adjust the partition")
        self._boundaries[key] = first
        return first

    # ------------------------------------------------------------------
    # the stage body
    # ------------------------------------------------------------------
    def _stage_fn(self, train: bool, mrng, labels, scaler):
        """The stage body over its boundary input: the stage's layers,
        and on the last stage the loss head (scaled by the loss scale
        when ``scaler``).  Parameters are fetched inside, so a
        checkpointed body fetches (gathers) them again when it
        recomputes."""
        pm, s = self.pipeline_module, self.stage_id
        start, stop = pm.stage_layer_range(s)
        rt, mesh = self._zero, self.mesh

        def body(x):
            params = rt.compute_tree(self._anchor)
            view = pm.stage_view(params, s, local=True)
            y = pm.forward_range(view, x, mrng, start, stop, train=train,
                                 mesh=mesh)
            if not self.is_last_stage:
                return y
            if self._loss_takes_params:
                lp = _ReplicatedParamsView(pm.replicated_view(params))
                lp.mesh = mesh
                loss = pm.loss_fn(lp, y, labels)
            else:
                loss = pm.loss_fn(y, labels)
            loss = loss.float()
            return loss if scaler is None else precision.scale_loss(
                loss, scaler)
        return body

    def _stages_uniform(self) -> bool:
        """The JAX engine's uniform-stage test (its
        ``_uniform_stack_info`` is not None): every stage runs the same
        count of rows of one stack, and the only other layers sit at the
        edges (a stage-0 prefix, a last-stage suffix)."""
        pm, S = self.pipeline_module, self.num_stages
        plan = pm.stack_plan()
        if S < 2 or len(plan) != 1:
            return False
        (stages,) = plan.values()
        k = len(stages[0])
        if k == 0 or any(len(r) != k for r in stages):
            return False
        parts = [pm.stage_layer_range(s) for s in range(S)]
        stacked = {i for r in stages for i in r}
        prefix = [i for i in range(*parts[0]) if i not in stacked]
        suffix = [i for i in range(*parts[S - 1]) if i not in stacked]
        return (all(i < min(stages[0]) for i in prefix)
                and all(i > max(stages[S - 1]) for i in suffix)
                and all(i in stacked for s in range(1, S - 1)
                        for i in range(*parts[s])))

    def _run(self, sched, inputs, labels, rng, train: bool, scaler=None):
        """Interpret ``sched`` for this stage; returns the sum of its
        micro-batch losses (scaled when ``scaler``; 0 off the last
        stage), a device scalar.  Parameter grads land in the ZeRO
        runtime's accumulators."""
        if self.sp_world_size > 1 and not self._stages_uniform():
            raise NotImplementedError(
                "sequence parallelism × pipeline needs a uniformly "
                "stacked PipelineModule (equal stacked rows per stage, "
                "non-stacked layers only as a stage-0 prefix / last-stage "
                "suffix) so the per-tick seq collectives are identical on "
                "every pipe rank; this module's partition is not uniform")
        pm, s, S = self.pipeline_module, self.stage_id, self.num_stages
        remat = pm.stage_remat and train
        shape, dtype = self._boundary(self._micro(inputs, 0))
        ch = self.channel
        bufs: Dict[int, dict] = {}
        acts: Dict[int, Any] = {}
        grads: Dict[int, Any] = {}
        nf = nb = 0
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        live = 0
        if train:
            self.max_live_boundaries = 0
        for step in sched.steps():
            sends, recvs, kinds = [], [], []
            for cmd in step:
                if isinstance(cmd, SendActivation):
                    sends.append((s + 1, bufs[cmd.buffer_id]["y"]))
                elif isinstance(cmd, SendGrad):
                    sends.append((s - 1, bufs[cmd.buffer_id].pop("gx")))
                elif isinstance(cmd, RecvActivation):
                    recvs.append((s - 1, torch.empty(
                        shape, dtype=dtype, device=self.device)))
                    kinds.append((acts, cmd.buffer_id))
                elif isinstance(cmd, RecvGrad):
                    recvs.append((s + 1, torch.empty(
                        shape, dtype=dtype, device=self.device)))
                    kinds.append((grads, cmd.buffer_id))
            for (table, buf), h in zip(kinds, ch.step(sends, recvs)):
                table[buf] = h
            for cmd in step:
                if isinstance(cmd, ForwardPass):
                    m, nf = nf, nf + 1
                    x = (self._micro(inputs, m) if s == 0
                         else ch.wait(acts.pop(cmd.buffer_id)))
                    if s > 0 and train:
                        x = x.detach().requires_grad_(True)
                    lb = self._micro(labels, m) if s == S - 1 else None
                    fn = self._stage_fn(train, fold_in(rng, m), lb, scaler)
                    with torch.set_grad_enabled(train):
                        out = (checkpoint(fn, x, use_reentrant=False,
                                          preserve_rng_state=False)
                               if remat else fn(x))
                    if s == S - 1:
                        total = total + out.detach()
                        entry = {"loss": out}
                    else:
                        entry = {"y": out}
                    if train:
                        entry["x"] = x
                        live += 1
                        self.max_live_boundaries = max(
                            self.max_live_boundaries, live)
                    bufs[cmd.buffer_id] = entry
                elif isinstance(cmd, BackwardPass):
                    nb += 1
                    entry = bufs[cmd.buffer_id]
                    if s == S - 1:
                        entry.pop("loss").backward()
                    else:
                        g = ch.wait(grads.pop(cmd.buffer_id))
                        torch.autograd.backward(entry.pop("y"), g)
                    x = entry.pop("x")
                    live -= 1
                    if s > 0:
                        entry["gx"] = x.grad.detach()
        ch.finish_sends()
        if nf != sched.micro_batches or (train and nb != nf):
            raise RuntimeError(
                f"pipeline stage {s} ran {nf} forwards and {nb} backwards "
                f"of {sched.micro_batches} micro-batches")
        return total

    @staticmethod
    def _micro(tree, m: int):
        return _tree_map(lambda a: a[m], tree)

    # ------------------------------------------------------------------
    # the step (the engine's _train_step runs the update around this)
    # ------------------------------------------------------------------
    def _scaled_grads(self, batch, scaler, step_rng, sharded=None,
                      keep=None):
        """Interpret the training schedule: fp32 grads summed over the
        micro-batches (and reduced over ``data``, the pipe-replicated
        ones over ``pipe`` too), unscaled by ``loss_scale · M · dp``; and
        the step's scaled mean loss, summed over ``pipe``."""
        if keep is not None:
            raise NotImplementedError(
                "a pipeline step computes every leaf's gradient")
        rt = self._zero
        M = self.micro_batches
        inputs, labels = batch
        rt.start_grads(self.zero_stage >= 2 if sharded is None else sharded)
        cls = GPipeSchedule if self.schedule == "gpipe" else TrainSchedule
        total = self._run(cls(M, self.num_stages, self.stage_id), inputs,
                          labels, fold_in(step_rng, 0), train=True,
                          scaler=scaler)
        grads = rt.finish_grads()
        inv = (1.0 / (scaler.loss_scale * (M * self.dp_world_size))).float()
        grads = [g * inv for g in grads]
        return grads, [col.psum(total / M, self.mesh, PIPE_AXIS)]

    # ------------------------------------------------------------------
    # evaluation and the refused facade
    # ------------------------------------------------------------------
    def eval_batch(self, batch=None, data_iter=None) -> torch.Tensor:
        """Forward-only pipelined evaluation over ``InferenceSchedule``
        (reference PipelineEngine.eval_batch, pipe/engine.py:305-363): the
        batch is split into the engine's micro-batches as in training;
        returns the mean micro-batch loss, the same on every rank."""
        if batch is None:
            if data_iter is None:
                raise ValueError(
                    "eval_batch needs a batch or a data_iter; it does not "
                    "fall back to the training iterator (that would consume "
                    "and advance the training data stream)")
            batch = next(data_iter)
        if isinstance(batch, DevicePlacedBatch):
            if batch.kind != "eval":
                raise ValueError(
                    f"eval_batch received a {batch.kind!r}-placed batch; "
                    "build the prefetcher with engine.prefetch(it, "
                    "for_eval=True)")
            batch = batch.ready()
        if not (isinstance(batch, (tuple, list)) and len(batch) == 2):
            raise ValueError("pipeline batch must be a (inputs, labels) pair")
        M = self.micro_batches
        leaves = tree_leaves(batch[0]) + tree_leaves(batch[1])
        n = leaves[0].shape[0]
        for x in leaves:
            if x.shape[0] % M != 0:
                raise ValueError(
                    f"eval batch dim {x.shape[0]} must be divisible by "
                    f"micro_batches ({M})")
        inputs = self._split(batch[0], n, self.is_first_stage, "eval batch")
        labels = self._split(batch[1], n, self.is_last_stage, "eval batch")
        with torch.no_grad():
            total = self._run(
                InferenceSchedule(M, self.num_stages, self.stage_id),
                inputs, labels, fold_in(self._data_rng, self.micro_steps),
                train=False)
            loss = col.psum(total / M, self.mesh, PIPE_AXIS)
            return col.pmean(loss, self.mesh, DATA_AXIS)

    def forward(self, batch):
        raise NotImplementedError(
            "the forward/backward/step facade is not supported on the "
            "pipeline engine — use train_batch/eval_batch (reference "
            "parity: those are the only entries there too, "
            "pipe/engine.py:229,305)")

    __call__ = forward

    # ------------------------------------------------------------------
    # checkpoints: the JAX package's packed tree, any saved depth
    # ------------------------------------------------------------------
    def load_checkpoint(self, load_dir, tag=None, load_optimizer_states=True,
                        load_lr_scheduler_states=True,
                        load_module_only=False):
        """Restore a pipeline checkpoint of either package, saved at this
        depth or another: a tree stacked for another pp is read whole and
        restacked by layer (``pipe.module.carry_params``)."""
        src = _saved_stages(load_dir, tag)
        pm = self.pipeline_module
        here = self.num_stages if pm.stack_plan() else None
        self._load_layout = (None if src is False or src == here
                             else pm.with_stages(src or 1))
        try:
            return super().load_checkpoint(
                load_dir, tag=tag,
                load_optimizer_states=load_optimizer_states,
                load_lr_scheduler_states=load_lr_scheduler_states,
                load_module_only=load_module_only)
        finally:
            self._load_layout = None

    def _checkpoint_state(self, templates: bool = False):
        master, opt = super()._checkpoint_state(templates)
        src = self._load_layout
        if not templates or src is None:
            return master, opt
        # the saved depth's whole packed tree as the load's template
        whole = src.pack(_meta_params(src, torch.float32))

        def pieces(_):
            return _tree_map(lambda t: ShardPiece(
                torch.empty(t.shape, dtype=torch.float32), t.shape,
                tuple((0, n) for n in t.shape), True), whole)
        return pieces(master), type(opt)(count=opt.count, mu=pieces(opt.mu),
                                         nu=pieces(opt.nu))

    def _adopt_loaded(self, master, opt_tree, scaler,
                      skipped_steps: int) -> None:
        rt = self._zero
        src = self._load_layout
        order = self.state.master_params

        def local(tree):
            if src is not None:
                # restack the saved depth's whole leaves, then this
                # rank's pieces of them
                pm = self.pipeline_module
                tree = pm.local_tree(carry_params(
                    tree, pm, src_stages=src.num_stages), self.stage_id)
                leaves = [rt.piece(x, i, rt.master_split(i)).clone()
                          for i, x in enumerate(tree_leaves(
                              _reorder(order, tree)))]
            else:
                leaves = [rt.unpiece(i, t) for i, t in
                          enumerate(tree_leaves(tree))]
            return _unflatten_like(order, leaves)

        master = local(master)
        if opt_tree is not None:
            opt_tree = type(opt_tree)(count=opt_tree.count,
                                      mu=local(opt_tree.mu),
                                      nu=local(opt_tree.nu))
        super()._adopt_loaded(master, opt_tree, scaler, skipped_steps)


def _reorder(order, tree):
    """``tree`` with ``order``'s dict key order."""
    if isinstance(order, dict):
        return {k: _reorder(order[k], tree[k]) for k in order}
    return tree


_STACK_KEY = re.compile(r"\['stack_\d+'\]")


def _saved_stages(load_dir: str, tag: Optional[str]):
    """The depth a saved pipeline tree was stacked for: its stacks'
    leading dim, None for a tree without stacks, False when the
    checkpoint cannot be read here (the load then reports why)."""
    try:
        if tag is None:
            with open(os.path.join(load_dir, "latest")) as f:
                tag = f.read().strip()
        for plane in ("optim", "model"):
            path = os.path.join(load_dir, tag, plane, "manifest.json")
            if os.path.exists(path):
                with open(path) as f:
                    manifest = json.load(f)
                break
        else:
            return False
    except (OSError, ValueError):
        return False
    for key, entry in manifest.items():
        if _STACK_KEY.search(key):
            return int(entry["shape"][0])
    return None

