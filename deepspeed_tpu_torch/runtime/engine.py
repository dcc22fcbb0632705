"""DeepSpeedEngine — the port of ``deepspeed_tpu/runtime/engine.py``'s
single-device training path (``_build_train_step``, ``_scan_scaled_grads``,
``_step_epilogue``, ``train_batch``).

One step = gradient accumulation over ``gradient_accumulation_steps``
micro-batches (fp32 gradient sums on the fp32 master through a
differentiable cast to the compute dtype), unscale by
``loss_scale * grad_acc``, the overflow check, the global norm, clipping,
Adam, the loss-scale update and the packed metrics.  As in the JAX step,
the overflow decision never leaves the card: a skipped step keeps the
master, the Adam state and its count (so the lr schedule does not advance
either) through ``torch.where``, and the step returns the device loss.
The host reads a value back only where the metrics are read
(``last_metrics``, ``get_loss_scale``, ``get_skipped_steps`` and the
``steps_per_print`` report).

Randomness is host integers (``runtime/module.py``): the step's seed is
``fold_in(rng, global_steps)`` and micro-batch i's ``fold_in(step, i)``,
as the JAX step folds its PRNG key.

Scope: data and tensor parallelism over a ``parallel.Mesh`` of
``torch.distributed`` ranks (NCCL on the card, gloo on the CPU) with ZeRO
stages 0–3 (``runtime/zero.py``: the fp32 master and the moments sharded
from stage 1, the grads reduce-scattered from stage 2, the compute
params gathered per block from stage 3), fp32/bf16/fp16 (dynamic loss
scale with hysteresis, skip on overflow), clipping, Adam/AdamW or LAMB,
the four lr schedules, progressive layer drop (θ advanced each step and
put into every micro-batch dict as a host float), ``eval_batch`` and the
forward/backward/step facade.

The data-parallel step (the JAX engine's ``_scan_scaled_grads``,
``constrain_grads`` and multi-process batch contract): each rank feeds
its own data coordinate's rows ``[grad_acc · micro, ...]`` (ranks that
differ only in ``model`` feed the same rows; ``deepspeed_io`` gives each
rank those rows); the grads are summed over the micro-steps in fp32 and
reduced over ``data`` (all-reduced at the boundary at stages 0–1,
reduce-scattered in the backward at stages 2–3); the overflow flag is
all-reduced with max, so every rank skips the same step; the global norm
and LAMB's trust ratios are the whole logical leaves' (a leaf's piece
sums reduced over its groups, a replicated leaf counted once); the loss
is the global mean, the same on every rank.  At one rank the same
collectives run (a one-rank NCCL group on the card); an engine with no
process group runs them as one-rank identities.  The
``data_prefetch`` block (on by default) runs inline here: the batch is
moved to the card inside ``train_batch``, a device tensor passes
straight through.

Checkpoints (``save_checkpoint``/``load_checkpoint``,
``runtime/checkpointing.py``) are the JAX package's on-disk format: the
``checkpoint`` block's async saves run on a daemon writer that ``close()``
drains, and ``checkpoint.sigterm_save`` installs the preemption hook, its
save deferred to the step boundary when the signal lands inside
``train_batch``.

The telemetry plane (docs/observability.md) is the JAX engine's:
``tensorboard`` scalars buffered to the ``steps_per_print`` sync, the
``telemetry`` hub (``train/*`` and ``checkpoint/*`` spans as host stamps,
``record_step`` per step, ``on_sync`` at the periodic sync), the heartbeat
and straggler monitor, the opt-in anomaly trigger, the flight recorder,
the ``profiler`` window (a ``torch.profiler`` capture exported as a Chrome
trace under ``profiler.output_path``) and the ``wall_clock_breakdown``
timers (which synchronize the card every step, as the reference's do).
Every other config knob whose path is not ported raises
``NotImplementedError`` naming its ROADMAP.md item: the pipeline (item
10); sequence, experts, 1-bit Adam and ``sparse_gradients`` (item 11);
offload (item 12); and async or SIGTERM saves across several processes
(item 9's remaining half).
"""
from __future__ import annotations

import collections
import contextlib
import os
import statistics
import threading
import time
import weakref
from typing import Any, Callable, List, NamedTuple, Optional

import numpy as np
import torch

from ..config import constants as C
from ..parallel import collectives as col
from ..parallel.distributed import is_initialized, local_rank
from ..parallel.mesh import (DATA_AXIS, MODEL_AXIS, Mesh, build_mesh,
                             mesh_axis_size, single_device_mesh)
from ..utils.logging import log_dist, logger
from . import precision
from .dataloader import DeepSpeedDataLoader, supports_iter_state
from .engine_stages import (finish_close, pop_stage_errors, stage_degraded,
                            wire_stage_plane)
from .lr_schedules import get_lr_schedule
from .resilience import AsyncCheckpointWriter
from .utils import clip_by_global_norm, fold_in, tree_leaves
from .zero import ZeroRuntime, ZeroShardingPlan
from ..ops.adam import fused_adam
from ..ops.lamb import fused_lamb
from .progressive_layer_drop import ProgressiveLayerDrop


class TrainState(NamedTuple):
    master_params: Any           # fp32 tree (dict) on the device
    opt_state: Any               # Adam/LAMB state over tree_leaves order
    scaler: precision.LossScaleState
    skipped_steps: torch.Tensor  # i32 device scalar


class StepMetrics(NamedTuple):
    loss: float
    grad_norm: float
    loss_scale: float
    overflow: bool
    lr: float


class _CallableInt(int):
    """An int that is also callable (the reference's accessor style)."""

    def __call__(self):
        return int(self)


class _CallableFloat(float):
    def __call__(self):
        return float(self)


def _unported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to deepspeed_tpu_torch yet: ROADMAP.md "
        f"queue 1, {item}")


def check_mesh(mesh) -> None:
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh must be a deepspeed_tpu_torch.parallel.Mesh "
            f"(parallel.build_mesh), got {type(mesh).__name__}")


def refuse_unported(config, optimizer=None, mesh=None) -> None:
    """Raise on every config knob whose training path this port does not
    run yet (defaults never raise)."""
    zc = config.zero_config
    if zc.cpu_offload:
        raise _unported("zero_optimization.cpu_offload",
                        "item 12 (offload and input pipeline)")
    check_mesh(mesh)
    if mesh is not None and mesh.size > 1 and (
            config.checkpoint_config.async_save
            or config.checkpoint_config.sigterm_save):
        raise _unported(
            "checkpoint.async_save / sigterm_save across processes",
            "item 9 (its remaining half)")
    if config.pipeline_config.stages != C.PIPELINE_STAGES_DEFAULT:
        raise _unported("pipeline.stages > 1", "item 10 (pipeline)")
    name = config.optimizer_name
    if optimizer is None and name not in (None, C.ADAM_OPTIMIZER,
                                          C.LAMB_OPTIMIZER):
        if name == C.ONEBIT_ADAM_OPTIMIZER:
            raise _unported("optimizer onebitadam",
                            "item 11 (compressed parallelism)")
        raise ValueError(f"Unknown optimizer {name!r}")
    if config.sparse_gradients_enabled:
        raise _unported("sparse_gradients", "item 11 (runtime/csr_tensor)")


def resolve_device(device) -> torch.device:
    """``cuda:LOCAL_RANK`` by default; raises without CUDA unless the
    caller names a device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "DeepSpeedEngine trains on the card by default and found no "
                "CUDA device; pass device='cpu' to train on the CPU")
        return torch.device("cuda", local_rank())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"DeepSpeedEngine: device {device} requested but "
                           "CUDA is not available")
    return device


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _unflatten_like(tree, leaves):
    """``leaves`` (``tree_leaves`` order) re-nested into ``tree``'s shape."""
    it = iter(leaves)
    return _tree_map(lambda _: next(it), tree)


def _master_leaf(x, device) -> torch.Tensor:
    """An owned copy on ``device``, fp32 for floating leaves."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
    dtype = torch.float32 if t.is_floating_point() else t.dtype
    return t.to(device, dtype, copy=True)


class DeepSpeedEngine:
    def __init__(self,
                 model,
                 config,
                 optimizer=None,
                 lr_schedule: Optional[Callable] = None,
                 params: Optional[Any] = None,
                 seed: int = 0,
                 training_data=None,
                 collate_fn=None,
                 device=None,
                 mesh=None):
        self.device = resolve_device(device)
        if mesh is None:
            mesh = build_mesh() if is_initialized() else single_device_mesh()
        refuse_unported(config, optimizer, mesh)
        self.module = model
        self.config = config
        self.mesh = mesh
        self.dp_world_size = mesh_axis_size(mesh, DATA_AXIS)
        if config.world_size != self.dp_world_size:
            raise ValueError(
                f"DeepSpeedConfig was built for world_size="
                f"{config.world_size} but the mesh's data axis is "
                f"{self.dp_world_size}; construct the config with the "
                "mesh's data-axis size (deepspeed_tpu_torch.initialize "
                "does this)")
        self.compute_dtype = precision.select_compute_dtype(
            config.fp16_enabled, config.bf16_enabled)
        self.micro_batch_size = _CallableInt(
            config.train_micro_batch_size_per_gpu)
        self.gradient_accumulation_steps = _CallableInt(
            config.gradient_accumulation_steps)
        self.train_batch_size = _CallableInt(config.train_batch_size)

        self._lr_schedule = self._resolve_lr_schedule(lr_schedule)
        self.progressive_layer_drop = (
            ProgressiveLayerDrop(theta=config.pld_config.theta,
                                 gamma=config.pld_config.gamma)
            if config.pld_config.enabled else None)
        clip = config.gradient_clipping
        self.gradient_clipping = _CallableFloat(
            float(clip) if clip and clip > 0 else 0.0)

        if params is None:
            params = model.init(seed, device=self.device)
        full = _tree_map(lambda x: _master_leaf(x, self.device), params)
        specs = getattr(model, "param_partition_specs", None)
        self.zero_plan = ZeroShardingPlan(
            stage=config.zero_optimization_stage, mesh=mesh,
            base_param_specs=specs(full) if specs is not None else None,
            params=full)
        self.zero_stage = self.zero_plan.stage
        self._zero = ZeroRuntime(self.zero_plan, full, self.compute_dtype,
                                 stacked=getattr(model, "stacked_layers",
                                                 None))
        # each rank keeps its pieces: the tensor-parallel piece, and from
        # stage 1 its data shard of it
        rt = self._zero
        pieces = []
        for i, x in enumerate(tree_leaves(full)):
            p = rt.piece(x, i, rt.master_split(i))
            pieces.append(p if p.numel() == x.numel() else p.clone())
        master = _unflatten_like(full, pieces)
        del full
        rt.set_sources(pieces)
        # the one input of every parameter fetch that requires grad, so
        # the fetches' backward (the gradient reduction) runs
        self._anchor = torch.zeros((), device=self.device,
                                   requires_grad=True)
        self._pg_check_pending = bool(config.zero_config.pg_correctness_test)
        self.optimizer = (optimizer if optimizer is not None
                          else self._build_basic_optimizer())
        scaler, self.loss_scale_config = precision.from_fp16_config(
            config.fp16, device=self.device)
        self.state = TrainState(
            master_params=master,
            opt_state=self.optimizer.init(tree_leaves(master)),
            scaler=scaler,
            skipped_steps=torch.zeros((), dtype=torch.int32,
                                      device=self.device))
        # host seeds: the counterparts of the JAX engine's PRNG keys
        self._rng = fold_in(seed, 1)
        self._data_rng = fold_in(seed, 2)

        self.global_steps = 0
        self.micro_steps = 0
        self._train_mode = True
        self._pending_micros: list = []
        self._last_packed: Optional[torch.Tensor] = None
        self._last_metrics: Optional[StepMetrics] = None
        self._step_times: List[float] = []
        self._train_data_iter = None
        self.training_dataloader = (
            self.deepspeed_io(training_data, collate_fn=collate_fn)
            if training_data is not None else None)
        self._tb_pending: list = []
        self._init_telemetry(config)
        # one fault plane (docs/stages.md): stage records + drain graph
        wire_stage_plane(self)
        self._init_checkpointing(config)
        self._init_finalizer()
        # the trace window (torch.profiler) and the per-phase timers;
        # enabling the timers syncs the card every step (the reference's
        # wall_clock_breakdown likewise cuda-synchronizes)
        self._profiler = None
        self._profiler_active = None
        if config.profiler_config.enabled:
            self._profiler = config.profiler_config
        self.timers = None
        if config.wall_clock_breakdown:
            from ..utils.timer import SynchronizedWallClockTimer
            self.timers = SynchronizedWallClockTimer(self.device)
        log_dist(
            f"DeepSpeedEngine: device={self.device} "
            f"zero_stage={self.zero_stage} dp={self.dp_world_size} "
            f"tp={mesh_axis_size(mesh, MODEL_AXIS)} "
            f"dtype={self.compute_dtype} "
            f"micro_bs={self.micro_batch_size} "
            f"grad_acc={self.gradient_accumulation_steps}", ranks=[0])

    def _init_telemetry(self, config) -> None:
        """TensorBoard scalars, the telemetry hub, the heartbeat and
        straggler monitor, the anomaly trigger and the flight recorder's
        one-dump-per-failure-class flag (reference ``engine.py:764-870``).
        Per-step recording is host-only; everything that reads the card
        rides the ``steps_per_print`` sync."""
        self.summary_writer = None
        if config.tensorboard_config.enabled:
            from ..utils.monitor import SummaryWriter
            self.summary_writer = SummaryWriter(
                output_path=config.tensorboard_config.output_path,
                job_name=config.tensorboard_config.job_name)
            # scalars are buffered until the steps_per_print sync; the
            # writer's own flush()/close() drain the buffer first so
            # either shutdown path sees every step.  The wrappers hold
            # the engine weakly: the GC finalizer keeps the WRITER alive
            # until the engine dies.
            _orig_flush = self.summary_writer.flush
            _orig_close = self.summary_writer.close
            eng_ref = weakref.ref(self)

            def _flush_all():
                eng = eng_ref()
                if eng is not None:
                    eng._flush_tensorboard()
                _orig_flush()

            def _close_all():
                eng = eng_ref()
                if eng is not None:
                    eng._flush_tensorboard()
                _orig_close()
            self.summary_writer.flush = _flush_all
            self.summary_writer.close = _close_all
        tcfg = config.telemetry_config
        self.telemetry = None
        if tcfg.enabled:
            from ..telemetry import TelemetryHub
            self.telemetry = TelemetryHub(
                tcfg.output_path or os.path.join(os.getcwd(), "telemetry"),
                trace=bool(tcfg.trace),
                compile_events=bool(tcfg.compile_events),
                memory=bool(tcfg.memory),
                storm_threshold=tcfg.recompile_storm_threshold,
                summary_writer=self.summary_writer,
                device=self.device)
            # the reference tracks each compiled program's retraces;
            # eager torch compiles none, so track() returns False
            self.telemetry.track_program("train_step", self._train_step)
        # elastic-training liveness (docs/elastic.md): a heartbeat file
        # each step when DS_HEARTBEAT_DIR is exported (the supervisor)
        # or telemetry.heartbeat is on; the straggler monitor reads the
        # fleet's files at the periodic sync.  Not gated on the hub.
        self._heartbeat = None
        self._straggler_monitor = None
        hb_dir = os.environ.get("DS_HEARTBEAT_DIR", "")
        if not hb_dir and tcfg.heartbeat:
            hb_dir = tcfg.heartbeat_dir or os.path.join(
                tcfg.output_path or os.path.join(os.getcwd(), "telemetry"),
                "heartbeats")
        if hb_dir:
            from ..telemetry.heartbeat import (HeartbeatWriter,
                                               StragglerMonitor)
            self._heartbeat = HeartbeatWriter(hb_dir,
                                              process_index=self.mesh.rank)
            self._straggler_monitor = StragglerMonitor(
                ratio=float(tcfg.straggler_ratio))
        # one-shot anomaly trigger (opt-in via telemetry.anomaly_ratio):
        # a slow interval or a self-straggler flag fires ONE flight dump
        # and one bounded profiler capture
        self._anomaly_ratio = float(tcfg.anomaly_ratio)
        self._anomaly_trail = collections.deque(maxlen=32)
        self._anomaly_fired = False
        self._anomaly_profiling = None
        # flight recorder: one post-mortem dump per failure class
        self._flightrec_poison_dumped = False

    def _init_checkpointing(self, config) -> None:
        """The async checkpoint writer (its thread starts with the first
        async save) under its ``ckpt_writer`` stage record — a writer
        that exhausts the stage's failure budget degrades to synchronous
        saves — the exposed-stall accounting the telemetry sync reads,
        and the opt-in SIGTERM preemption hook."""
        self._ckpt_writer = AsyncCheckpointWriter(
            stage=self._stage_records["ckpt_writer"])
        self._ckpt_interval_acc = {"save_s": 0.0, "overlap_s": 0.0,
                                   "saves": 0, "writes": 0}
        # guards the acc against the writer thread's overlap_s updates
        # racing the telemetry sync's read-and-reset
        self._ckpt_acc_lock = threading.Lock()
        self._ckpt_last_save_dir = None
        self.last_ckpt_error = None
        self.last_loaded_data_iter_state = None
        self._in_step = False          # SIGTERM-save deferral fence
        self._deferred_preempt = None  # handler parked until step boundary
        self._preemption_handler = None
        ckc = config.checkpoint_config
        if ckc.sigterm_save:
            from .resilience import install_preemption_handler
            self._preemption_handler = install_preemption_handler(
                self, ckc.save_dir or None)

    def _init_finalizer(self) -> None:
        """GC/exit finalizer: a dropped engine's in-flight save lands
        first, then its buffered scalars and trace file flush.  It holds
        only the output objects (not the engine), so the engine stays
        collectable."""
        closeables = (self._ckpt_writer,) + tuple(
            c for c in (self.summary_writer, self.telemetry)
            if c is not None)
        self._finalizer = weakref.finalize(
            self, _close_quietly, closeables, tb_pending=self._tb_pending,
            writer=self.summary_writer)

    # ------------------------------------------------------------------
    # configuration
    # ------------------------------------------------------------------
    def _resolve_lr_schedule(self, client_schedule):
        if client_schedule is not None:
            if not callable(client_schedule):
                raise TypeError(
                    "lr_scheduler must be a callable step -> lr (got "
                    f"{type(client_schedule)}); use the config 'scheduler' "
                    "block or a callable")
            return client_schedule
        cfg = self.config
        if cfg.scheduler_name is not None:
            return get_lr_schedule(cfg.scheduler_name, cfg.scheduler_params)
        return None

    def _build_basic_optimizer(self):
        params = dict(self.config.optimizer_params)
        lr = params.pop("lr", 1e-3)
        if self._lr_schedule is not None:
            lr = self._lr_schedule
        args = (lr, tuple(params.pop("betas", (0.9, 0.999))),
                params.pop("eps", 1e-8), params.pop("weight_decay", 0.0))
        if self.config.optimizer_name == C.LAMB_OPTIMIZER:
            return fused_lamb(*args,
                              max_coeff=params.pop("max_coeff", 10.0),
                              min_coeff=params.pop("min_coeff", 0.01),
                              leaf_sums=self._zero.leaf_sums)
        return fused_adam(*args,
                          adam_w_mode=params.pop("adam_w_mode", True),
                          bias_correction=params.pop("bias_correction",
                                                     True))

    def _lr_at(self, count: torch.Tensor) -> torch.Tensor:
        if self._lr_schedule is not None:
            return torch.as_tensor(self._lr_schedule(count),
                                   dtype=torch.float32, device=self.device)
        # a fill kernel: a tensor copied from the host would sync
        return torch.full((), float(self.config.optimizer_params.get(
            "lr", 1e-3)), dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------
    def _scaled_grads(self, batch, scaler, step_rng, sharded=None):
        """Sum fp32 grads of the scaled micro-batch losses over the
        micro-steps and the data ranks (``runtime/zero.py``; ``sharded``
        overrides the stage's gradient placement — False is the plain
        all-reduce the partitioning check compares with) and unscale by
        ``loss_scale * grad_acc * dp``.  Returns (grads in tree_leaves
        order, in the master's placement; scaled losses)."""
        rt = self._zero
        ga = int(self.gradient_accumulation_steps)
        rt.start_grads(self.zero_stage >= 2 if sharded is None
                       else sharded)
        scaled_losses = []
        for i in range(ga):
            mb = _tree_map(lambda x: x[i], batch)
            if self.progressive_layer_drop is not None \
                    and isinstance(mb, dict):
                # a host float: the model's layer draws never sync
                mb["pld_theta"] = self.progressive_layer_drop.get_theta()
            params = rt.compute_tree(self._anchor)
            loss = self.module.loss_fn(params, mb, fold_in(step_rng, i),
                                       train=True)
            scaled = precision.scale_loss(loss.float(), scaler)
            scaled.backward()
            scaled_losses.append(scaled.detach())
        grads = rt.finish_grads()
        inv = (1.0 / (scaler.loss_scale * (ga * self.dp_world_size))).float()
        return [g * inv for g in grads], scaled_losses

    def _global_norm(self, grads) -> torch.Tensor:
        """The L2 norm of the logical gradient tree (every rank gets it)."""
        sq = torch.stack([g.float().square().sum() for g in grads])
        return self._zero.leaf_sums(sq[:, None])[:, 0].sum().sqrt()

    def _all_finite(self, grads) -> torch.Tensor:
        """Every rank's grads finite (the non-finite flag all-reduced with
        max, so every rank skips the same step)."""
        bad = (~precision.grads_finite(grads)).float()
        return col.pmax(bad, self.mesh, "world") == 0

    # ------------------------------------------------------------------
    # partitioning correctness (the JAX engine's pg_correctness_test and
    # verify_gradient_partitioning)
    # ------------------------------------------------------------------
    def verify_gradient_partitioning(self, batch=None, data_iter=None,
                                     rtol: float = 2e-5,
                                     atol: float = 2e-5):
        """Compute one batch's gradients twice — through the stage's
        placement (reduce-scattered from stage 2) and through the plain
        all-reduce — and assert they match on every rank's pieces.
        Returns ``{"max_abs_diff", "max_rel_diff"}`` (the maxima over
        every rank)."""
        if batch is None:
            if data_iter is None:
                raise ValueError(
                    "verify_gradient_partitioning needs a batch or "
                    "data_iter")
            batch = next(data_iter)
        return self._run_pg_correctness(self._place_train_batch(batch),
                                        rtol=rtol, atol=atol)

    def _run_pg_correctness(self, placed, rtol=2e-5, atol=2e-5):
        scaler = self.state.scaler
        rng = fold_in(self._rng, self.global_steps)
        g_plan, _ = self._scaled_grads(placed, scaler, rng)
        g_ref, _ = self._scaled_grads(placed, scaler, rng, sharded=False)
        stats = torch.zeros(3, dtype=torch.float64, device=self.device)
        with torch.no_grad():
            for a, b in zip(g_plan, g_ref):
                a, b = a.double(), b.double()
                diff = (a - b).abs()
                if diff.numel():
                    stats[0] = torch.maximum(stats[0], diff.max())
                    stats[1] = torch.maximum(stats[1], (
                        diff / b.abs().clamp_min(1e-12)).max())
                stats[2] += (~torch.isclose(a, b, rtol=rtol,
                                            atol=atol)).sum()
        max_abs, max_rel, bad = col.pmax(stats, self.mesh,
                                         "world").tolist()
        if bad:
            raise AssertionError(
                f"pg_correctness_test FAILED: partitioned grads diverge "
                f"from the replicated reduction on {int(bad)} elements "
                f"(max_abs={max_abs:.3e} max_rel={max_rel:.3e})")
        log_dist(f"pg_correctness_test OK: max_abs={max_abs:.3e} "
                 f"max_rel={max_rel:.3e}", ranks=[0])
        return {"max_abs_diff": max_abs, "max_rel_diff": max_rel}

    @torch.no_grad()
    def _apply_update(self, grads, finite):
        """Adam on the master, kept only where ``finite`` (device bool):
        a skipped step leaves the master, the moments and the count as
        they were."""
        st = self.state
        leaves = tree_leaves(st.master_params)
        updates, new = self.optimizer.update(grads, st.opt_state, leaves)
        for p, u in zip(leaves, updates):
            p.copy_(torch.where(finite, p + u, p))
        old = st.opt_state
        return type(old)(
            count=torch.where(finite, new.count, old.count),
            mu=[torch.where(finite, a, b) for a, b in zip(new.mu, old.mu)],
            nu=[torch.where(finite, a, b) for a, b in zip(new.nu, old.nu)])

    def _train_step(self, batch) -> torch.Tensor:
        """One step on a placed batch [grad_acc, micro, ...]; returns the
        packed metrics vector (device)."""
        st = self.state
        scaler = st.scaler
        step_rng = fold_in(self._rng, self.global_steps)
        grads, scaled_losses = self._scaled_grads(batch, scaler, step_rng)
        with torch.no_grad():
            finite = self._all_finite(grads)
            grad_norm = self._global_norm(grads)
            if self.gradient_clipping > 0:
                grads, _ = clip_by_global_norm(grads, self.gradient_clipping,
                                               norm=grad_norm)
        new_opt = self._apply_update(grads, finite)
        with torch.no_grad():
            # stages 1-2: the compute copy all-gathered from the shards
            self._zero.set_sources(tree_leaves(st.master_params))
            mean_loss = col.pmean(
                torch.stack(scaled_losses).mean() / scaler.loss_scale,
                self.mesh, DATA_AXIS)
            new_scaler = precision.update_scale(scaler, finite,
                                                self.loss_scale_config)
            new_skipped = st.skipped_steps + (~finite).to(torch.int32)
            # lr at the applied-step count: skipped steps do not advance
            # the schedule
            applied = (self.global_steps + 1) - new_skipped
            packed = torch.stack([
                mean_loss.float(), grad_norm.float(),
                scaler.loss_scale.float(), (~finite).float(),
                self._lr_at(applied).reshape(())])
        self.state = TrainState(master_params=st.master_params,
                                opt_state=new_opt, scaler=new_scaler,
                                skipped_steps=new_skipped)
        return packed

    # ------------------------------------------------------------------
    # batches
    # ------------------------------------------------------------------
    def deepspeed_io(self, dataset, batch_size=None, collate_fn=None):
        """A loader of global batches that yields this rank's rows of
        each (its data coordinate's, ``[grad_acc · micro, ...]``)."""
        return DeepSpeedDataLoader(
            dataset, batch_size=batch_size or self.train_batch_size,
            collate_fn=collate_fn,
            data_shard=(int(self.gradient_accumulation_steps),
                        self.dp_world_size,
                        self.mesh.axis_index(DATA_AXIS)))

    def _to_device(self, x) -> torch.Tensor:
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
            np.asarray(x))
        return t.to(self.device, non_blocking=True)

    def _place_train_batch(self, batch):
        """This rank's [grad_acc · micro, ...] leaves → [grad_acc, micro,
        ...] on the card."""
        ga, mb = int(self.gradient_accumulation_steps), int(
            self.micro_batch_size)
        dp = self.dp_world_size

        def place(x):
            t = self._to_device(x)
            if t.shape[0] != ga * mb:
                raise ValueError(
                    f"batch dim {t.shape[0]} != this rank's rows {ga * mb}"
                    f" (grad_acc {ga} × micro {mb}; train_batch_size "
                    f"{ga * mb * dp} = that × dp {dp}, each data rank "
                    "feeding its own rows)")
            return t.reshape((ga, mb) + tuple(t.shape[1:]))

        return _tree_map(place, batch)

    def _training_iter(self):
        """Persistent iterator over the training dataloader."""
        if self.training_dataloader is None:
            return None
        if self._train_data_iter is None:
            self._train_data_iter = iter(self.training_dataloader)
        return self._train_data_iter

    # ------------------------------------------------------------------
    # public training API
    # ------------------------------------------------------------------
    def train_batch(self, batch=None, data_iter=None) -> torch.Tensor:
        """Run one full training step (grad-accum included) on a global
        batch of ``train_batch_size`` samples; returns the mean loss as a
        device scalar (no host sync).  A SIGTERM landing inside the step
        parks the preemption save until the step's end, where the state
        is whole again.  A failing step dumps the fault plane's recent
        history once (the flight recorder); StopIteration is the end of
        an epoch, never a failure."""
        self._in_step = True
        try:
            return self._train_batch_inner(batch, data_iter)
        except BaseException as e:
            if not isinstance(e, StopIteration) \
                    and not self._flightrec_poison_dumped:
                self._flightrec_poison_dumped = True
                self.dump_flight_record(reason="train_batch failure",
                                        error=e)
            raise
        finally:
            self._in_step = False
            h = self._deferred_preempt
            if h is not None:
                self._deferred_preempt = None
                h.complete_deferred()

    def _train_batch_inner(self, batch, data_iter) -> torch.Tensor:
        self._ckpt_writer_tick()
        if batch is None:
            it = data_iter or self._training_iter()
            if it is None:
                raise ValueError("train_batch needs a batch or a data_iter")
            batch = next(it)
        t0 = time.time()
        if self.progressive_layer_drop is not None:
            self.progressive_layer_drop.update_state(self.global_steps)
        if self.timers is not None:
            self.timers("train_batch_data").start()
        self._profiler_window_tick()
        # telemetry spans are HOST stamps (perf_counter + a list append):
        # a dispatch span measures enqueue latency, and the periodic
        # on_sync emits the synced ground truth — no read of the card is
        # added per step
        with self._tel_span("train/shard_batch", cat="data",
                            prefetched=False):
            placed = self._place_train_batch(batch)
        if self._pg_check_pending:
            # first-step sweep, before any update mutates the state
            self._pg_check_pending = False
            self._run_pg_correctness(placed)
        if self.timers is not None:
            self.timers("train_batch_data").stop()
            self.timers("train_batch_step").start()
        # the POST-increment step number, so the span correlates with
        # record_step / on_sync / the report line for the same batch
        with self._tel_span("train/dispatch", cat="train",
                            step=self.global_steps + 1):
            packed = self._train_step(placed)
            self._last_packed = packed
            self._last_metrics = None
        if self.timers is not None:
            # materializing the metrics is the device sync
            _ = self.last_metrics
            self.timers("train_batch_step").stop()
        self.global_steps += 1
        self.micro_steps += int(self.gradient_accumulation_steps)
        # enqueue time only: the synced rate comes from _report's interval
        dispatch_s = time.time() - t0
        self._step_times = (self._step_times + [dispatch_s])[-10:]
        if self._heartbeat is not None:
            # liveness beat (an atomic small-file write); step_s is the
            # wall between beats, which the straggler monitor medians
            self._heartbeat.beat(self.global_steps)
            if self.telemetry is not None:
                self.telemetry.registry.gauge(
                    "heartbeat_step",
                    "last step this process heartbeat for (elastic "
                    "liveness)").set(self.global_steps)
        if self.telemetry is not None:
            self.telemetry.record_step(self.global_steps, dispatch_s,
                                       samples=int(self.train_batch_size))
        if self.summary_writer is not None:
            # buffer the device metrics; the flush rides the
            # steps_per_print sync instead of reading every step
            self._tb_pending.append(
                (self.global_steps,
                 self._last_packed if self._last_metrics is None
                 else self._last_metrics))
            if len(self._tb_pending) >= 1000:
                self._flush_tensorboard()
        if self.global_steps % self.config.steps_per_print == 0:
            if self.timers is not None:
                self.timers.log(["train_batch_data", "train_batch_step"])
            # interval bookkeeping BEFORE _report (which resets it): the
            # telemetry sync reuses the same synced wall-clock window
            prev_t = getattr(self, "_last_report", None)
            prev_step = getattr(self, "_last_report_step", 0)
            self._report(self.last_metrics)
            self._flush_tensorboard()
            if self.telemetry is not None:
                self._telemetry_sync(prev_t, prev_step)
        return packed[0]

    def _tel_span(self, name: str, cat: str = "runtime", **args):
        """Telemetry span context — a nullcontext when telemetry is off,
        so call sites stay unconditional.  Host-side stamps only; never
        a device sync."""
        tel = getattr(self, "telemetry", None)
        if tel is None:
            return contextlib.nullcontext()
        return tel.span(name, cat=cat, **args)

    def _start_capture(self):
        """A started ``torch.profiler`` capture of the host and, on a
        CUDA engine, the card's kernels."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        return prof

    @staticmethod
    def _export_capture(prof, out_dir: str, name: str) -> str:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, name)
        prof.export_chrome_trace(path)
        return path

    def _profiler_window_tick(self):
        """Open/close the capture window around train_batch calls: steps
        ``[start_step, start_step + num_steps)`` are traced."""
        p = self._profiler
        if p is None:
            return
        if (self._profiler_active is None
                and p.start_step <= self.global_steps
                < p.start_step + p.num_steps):
            # upper bound matters: a run resumed from a checkpoint past the
            # window must not open a stray one-step trace
            self._anomaly_stop()  # defensive: one capture at a time
            self._profiler_active = self._start_capture()
        elif (self._profiler_active is not None
              and self.global_steps >= p.start_step + p.num_steps):
            self.stop_profiler()

    def stop_profiler(self):
        """Finalize the trace window (idempotent; also the escape hatch if
        training ends inside it): a Chrome trace
        ``<profiler.output_path>/trace_steps<a>-<b>.json``."""
        prof = self._profiler_active
        if prof is None:
            return
        with self._tel_span("profiler/stop_trace", cat="profiler",
                            step=self.global_steps):
            # device sync: the window must contain the work — one of the
            # engine's existing sync points telemetry rides
            _ = self.last_metrics
            prof.stop()
        self._profiler_active = None
        p = self._profiler
        self._profiler = None
        path = self._export_capture(
            prof, p.output_path,
            f"trace_steps{p.start_step}-{self.global_steps - 1}.json")
        log_dist(f"profiler: Chrome trace written to {path}", ranks=[0])

    def _telemetry_sync(self, prev_t, prev_step):
        """Telemetry's periodic drain, riding the steps_per_print sync
        that ``_report``'s metrics read already paid for: the synced
        step-time histogram, memory gauges, checkpoint stalls, the
        heartbeat fleet's health and the exporters' flushes.  The first
        interval has no synced baseline (prev_t is None) and records no
        step-time sample."""
        m = self.last_metrics
        steps = self.global_steps - prev_step
        interval = (self._last_report - prev_t) if prev_t is not None \
            else None
        # anomaly check FIRST: it also closes a previous trigger's
        # bounded capture, and it must run before the straggler block —
        # a straggler-arm fire later in THIS sync would otherwise open a
        # capture this same sync immediately stops
        self._anomaly_check(interval / steps
                            if interval is not None and steps else None)
        scalars = {}
        if m is not None:
            scalars = {"loss": float(m.loss),
                       "grad_norm": float(m.grad_norm),
                       "loss_scale": float(m.loss_scale),
                       "lr": float(m.lr)}
        ca = self._ckpt_interval_acc
        if ca["saves"]:
            # exposed per-save stall (sync: the whole serialize; async:
            # just the host snapshot) and the background write time the
            # async path hid — summarize's checkpoint row.  Read-and-
            # reset under the lock: the writer thread adds overlap_s
            with self._ckpt_acc_lock:
                scalars["ckpt_save_s"] = ca["save_s"] / ca["saves"]
                if ca["overlap_s"] > 0:
                    # per WRITTEN save (coalesced submissions never wrote)
                    scalars["ckpt_async_overlap_s"] = (
                        ca["overlap_s"] / max(ca.get("writes", 0), 1))
                ca.update(save_s=0.0, overlap_s=0.0, saves=0, writes=0)
        if self._straggler_monitor is not None \
                and self._heartbeat is not None:
            # fleet health from the shared heartbeat dir: flag hosts
            # whose step time exceeds straggler_ratio × the fleet
            # median; detections count ONCE per flagged episode
            from ..telemetry.heartbeat import beat_ages, read_heartbeats
            beats = read_heartbeats(self._heartbeat.directory)
            age_gauge = self.telemetry.registry.gauge(
                "heartbeat_age_s",
                "seconds since each host's last heartbeat (elastic "
                "liveness; stale = hung host)")
            for key, age in beat_ages(beats).items():
                age_gauge.set(age, host=key)
            rep = self._straggler_monitor.update(beats)
            if rep["new_stragglers"]:
                self.telemetry.registry.counter(
                    "straggler_detected_total",
                    "hosts flagged slower than straggler_ratio x the "
                    "fleet median step time").inc(
                    len(rep["new_stragglers"]))
                logger.warning(
                    "straggler(s) detected: %s (fleet median %.3fs/step, "
                    "ratio %.1fx)", ", ".join(rep["new_stragglers"]),
                    rep["median_step_s"] or 0.0,
                    self._straggler_monitor.ratio)
                self_key = (f"{self._heartbeat.host}/"
                            f"{self._heartbeat.process_index}")
                if self_key in rep["new_stragglers"]:
                    # the anomaly trigger's straggler arm: THIS host is
                    # the slow one — capture it while it is still slow
                    self._fire_anomaly(
                        f"this host flagged as straggler ({self_key})")
            scalars["straggler_detected_total"] = float(
                self._straggler_monitor.flagged_total)
        self.telemetry.on_sync(
            self.global_steps,
            interval_s=interval,
            steps=steps if interval is not None else None,
            samples_per_step=int(self.train_batch_size),
            scalars=scalars)

    def _flush_tensorboard(self):
        if self.summary_writer is None or not self._tb_pending:
            return
        # in-place drain: the GC finalizer holds this SAME list object
        _drain_tb_pending(self._tb_pending, self.summary_writer)

    # ------------------------------------------------------------------
    # flight recorder + anomaly trigger (docs/observability.md)
    # ------------------------------------------------------------------
    def dump_flight_record(self, reason: str = "manual", error=None,
                           directory: Optional[str] = None
                           ) -> Optional[str]:
        """Dump every stage's bounded event ring (call outcomes, queue
        depths, failures, degradations) as ``flightrec_<step>.json`` for
        post-mortem (``python -m deepspeed_tpu_torch.telemetry
        diagnose``).  Fired on a train_batch failure, a stage
        degradation, the SIGTERM preemption hook and the anomaly trigger;
        callable on demand.  Never raises; returns the path, or None when
        no telemetry output directory exists to hold it."""
        try:
            if directory is None:
                if self.telemetry is None:
                    logger.warning(
                        "flight record NOT dumped (%s): telemetry is "
                        "disabled and no directory was given", reason)
                    return None
                directory = self.telemetry.output_path
            from ..telemetry.hub import write_flight_record
            extra = {}
            if self.last_ckpt_error is not None:
                extra["last_ckpt_error"] = repr(self.last_ckpt_error)
            if getattr(self, "last_stage_error", None) is not None:
                extra["last_stage_error"] = repr(self.last_stage_error)
            path = write_flight_record(
                directory, getattr(self, "_stage_records", {}),
                self.global_steps, reason, error=error,
                extra=extra or None)
            logger.warning("flight record dumped to %s (%s)", path,
                           reason)
            return path
        except Exception:
            logger.exception("flight-record dump failed (reason=%r)",
                             reason)
            return None

    def _anomaly_stop(self):
        """Close a trigger-opened capture (bounded: the window is one
        sync interval — or engine.close, whichever first)."""
        prof = self._anomaly_profiling
        if prof is None:
            return
        self._anomaly_profiling = None
        try:
            prof.stop()
            self._export_capture(
                prof, os.path.join(self.telemetry.output_path,
                                   "anomaly_profile"),
                f"trace_step{self.global_steps}.json")
            log_dist("anomaly profiler capture closed", ranks=[0])
        except Exception as e:
            logger.warning("anomaly profiler capture stop failed: %s", e)

    def _fire_anomaly(self, reason: str):
        """One-shot (per run) anomaly response: a flight-record dump and
        a bounded profiler capture.  Opt-in — inert unless
        ``telemetry.anomaly_ratio`` is set."""
        if self._anomaly_ratio <= 0 or self._anomaly_fired:
            return
        self._anomaly_fired = True
        logger.warning(
            "telemetry anomaly trigger: %s — dumping a flight record "
            "and starting ONE bounded profiler capture", reason)
        self.dump_flight_record(reason=f"anomaly: {reason}")
        if self.telemetry is None or self._profiler_active is not None \
                or self._profiler is not None:
            # never stack on a user-configured capture window, open OR
            # still pending
            return
        try:
            self._anomaly_profiling = self._start_capture()
        except Exception as e:
            logger.warning("anomaly profiler capture failed to "
                           "start: %s", e)

    def _anomaly_check(self, avg: Optional[float]):
        """Step-time arm of the anomaly trigger, at the periodic sync:
        fire when this interval's per-step time exceeds
        ``telemetry.anomaly_ratio`` × the trailing median.  Also where a
        previous trigger's capture closes (bounded to one interval)."""
        self._anomaly_stop()
        if avg is None:
            return
        if (self._anomaly_ratio > 0 and not self._anomaly_fired
                and len(self._anomaly_trail) >= 4):
            med = statistics.median(self._anomaly_trail)
            if med > 0 and avg > self._anomaly_ratio * med:
                self._fire_anomaly(
                    f"interval step time {avg:.4f}s/step > "
                    f"{self._anomaly_ratio:g}x trailing median "
                    f"{med:.4f}s/step")
        # appended AFTER the check: the anomalous interval must not
        # dilute its own baseline
        self._anomaly_trail.append(avg)

    def eval_batch(self, batch=None, data_iter=None) -> torch.Tensor:
        """Forward-only loss on one micro-batch (``train=False``).  A
        no-arg call raises instead of consuming the training iterator."""
        if batch is None:
            if data_iter is None:
                raise ValueError(
                    "eval_batch needs a batch or a data_iter; it does not "
                    "fall back to the training iterator (that would consume "
                    "and advance the training data stream)")
            batch = next(data_iter)
        micro = _tree_map(self._to_device, batch)
        with torch.no_grad():
            params = self._zero.compute_tree(self._anchor)
            loss = self.module.loss_fn(
                params, micro, fold_in(self._data_rng, self.micro_steps),
                train=False)
            return col.pmean(loss, self.mesh, DATA_AXIS)

    # --- reference-style imperative facade -----------------------------
    def forward(self, batch):
        """Compat shim for the reference trio: computes the micro-batch
        loss (an eval pass) and queues the batch for the fused step."""
        loss = self.eval_batch(batch)
        self._pending_micros.append(batch)
        return loss

    __call__ = forward

    def backward(self, loss):
        """No-op gradient marker (gradients happen inside the fused step)."""
        self.micro_steps += 1
        return loss

    def is_gradient_accumulation_boundary(self) -> bool:
        return len(self._pending_micros) >= self.gradient_accumulation_steps

    def step(self):
        if not self.is_gradient_accumulation_boundary():
            return None
        ga = int(self.gradient_accumulation_steps)
        micros = self._pending_micros[:ga]
        self._pending_micros = self._pending_micros[ga:]

        def cat(*xs):
            return torch.cat([self._to_device(x) for x in xs], dim=0)

        first = micros[0]
        if isinstance(first, dict):
            batch = {k: cat(*(m[k] for m in micros)) for k in first}
        elif isinstance(first, (tuple, list)):
            batch = type(first)(cat(*(m[i] for m in micros))
                                for i in range(len(first)))
        else:
            batch = cat(*micros)
        self.micro_steps -= ga  # train_batch re-adds
        return self.train_batch(batch)

    # ------------------------------------------------------------------
    # checkpointing (reference engine.py:1211-1478)
    # ------------------------------------------------------------------
    def save_checkpoint(self, save_dir, tag=None, client_state=None,
                        save_latest=True, async_write=None):
        """Write ``<save_dir>/<tag>/`` (``global_step<N>`` by default) and
        return its path.  ``async_write=True`` copies the state to the
        host and hands serialization to the daemon writer — the step loop
        pays only that copy; ``None`` takes the ``checkpoint.async_save``
        config, and a degraded writer saves synchronously."""
        if async_write is None:
            async_write = bool(self.config.checkpoint_config.async_save)
        if async_write:
            # a degraded writer saves synchronously (docs/stages.md)
            async_write = not stage_degraded(self, "ckpt_writer")
        from .checkpointing import save_checkpoint
        t0 = time.perf_counter()
        with self._tel_span("checkpoint/save", cat="checkpoint",
                            step=self.global_steps,
                            **{"async": bool(async_write)}):
            out = save_checkpoint(self, save_dir, tag=tag,
                                  client_state=client_state,
                                  save_latest=save_latest,
                                  async_write=bool(async_write))
        self._ckpt_last_save_dir = save_dir
        # exposed stall only: an async save returns after the snapshot,
        # so this is the number the ckpt_save_s telemetry scalar reports
        # (the background write lands in overlap_s via the writer job)
        with self._ckpt_acc_lock:
            acc = self._ckpt_interval_acc
            acc["save_s"] += time.perf_counter() - t0
            acc["saves"] += 1
        return out

    def load_checkpoint(self, load_dir, tag=None,
                        load_optimizer_states=True,
                        load_lr_scheduler_states=True,
                        load_module_only=False):
        """Restore a checkpoint this package or the JAX package wrote;
        returns ``(load_path, client_state)``, ``(None, None)`` when
        ``load_dir`` holds no ``latest``."""
        from .checkpointing import load_checkpoint
        with self._tel_span("checkpoint/load", cat="checkpoint"):
            return load_checkpoint(
                self, load_dir, tag=tag,
                load_optimizer_states=load_optimizer_states,
                load_lr_scheduler_states=load_lr_scheduler_states,
                load_module_only=load_module_only)

    def _canonical_state(self):
        """(master, optimizer state) in the JAX engine's tree form: the
        count and the moments re-nested onto the param tree (this rank's
        pieces of each leaf)."""
        master = self.state.master_params
        opt = self.state.opt_state
        if not all(hasattr(opt, f) for f in ("count", "mu", "nu")):
            raise NotImplementedError(
                f"checkpointing a {type(opt).__name__} optimizer state: "
                "only the count/mu/nu states of Adam and LAMB have the "
                "JAX package's checkpoint layout")
        return master, type(opt)(count=opt.count,
                                 mu=_unflatten_like(master, opt.mu),
                                 nu=_unflatten_like(master, opt.nu))

    def _checkpoint_state(self):
        """``_canonical_state`` with each param-shaped leaf as this rank's
        ``ShardPiece`` of it: what the checkpoint writes and loads into."""
        master, opt = self._canonical_state()

        def pieces(tree):
            return _unflatten_like(
                tree, self._zero.shard_pieces(tree_leaves(tree)))
        return pieces(master), type(opt)(count=opt.count,
                                         mu=pieces(opt.mu),
                                         nu=pieces(opt.nu))

    def _adopt_loaded(self, master, opt_tree, scaler,
                      skipped_steps: int) -> None:
        """Install loaded trees: ``opt_tree`` None (a module-only load)
        starts the optimizer afresh on the loaded master."""
        leaves = tree_leaves(master)
        if opt_tree is None:
            opt_state = self.optimizer.init(leaves)
        else:
            opt_state = type(opt_tree)(count=opt_tree.count,
                                       mu=tree_leaves(opt_tree.mu),
                                       nu=tree_leaves(opt_tree.nu))
        self.state = TrainState(
            master_params=master, opt_state=opt_state, scaler=scaler,
            skipped_steps=torch.tensor(skipped_steps, dtype=torch.int32,
                                       device=self.device))
        self._zero.set_sources(leaves)

    def data_iterator_state(self):
        """The training loader's position (JSON-able), or None without a
        checkpointable loader — the checkpoint's data plane."""
        for cand in (self._train_data_iter, self.training_dataloader):
            if cand is not None and supports_iter_state(cand):
                try:
                    return cand.state_dict()
                except TypeError:
                    return None
        return None

    def load_data_iterator_state(self, state) -> bool:
        """Apply a checkpointed loader position; the next ``train_batch``
        rebuilds its iterator from there.  The state is kept as
        ``last_loaded_data_iter_state`` either way."""
        self.last_loaded_data_iter_state = state
        loader = self.training_dataloader
        if loader is None or not supports_iter_state(loader):
            logger.warning(
                "checkpoint has a data-iterator plane but this engine has "
                "no checkpointable training dataloader to apply it to: "
                "apply engine.last_loaded_data_iter_state to your loader "
                "with load_state_dict()")
            return False
        loader.load_state_dict(state)
        self._train_data_iter = None
        return True

    def _ckpt_writer_tick(self):
        """Pre-step surfacing of a failed async save (it poisoned only
        that save; training continues and the next save retries): it
        lands in ``last_ckpt_error`` and the failure counter."""
        err = self._ckpt_writer.pop_error()
        if err is not None:
            self.last_ckpt_error = err
            if self.telemetry is not None:
                self.telemetry.registry.counter(
                    "ckpt_save_failures_total",
                    "checkpoint saves that failed (async writer or sync)",
                ).inc()
        # post-close stage failures land in last_stage_error
        pop_stage_errors(self)

    # ------------------------------------------------------------------
    # shutdown
    # ------------------------------------------------------------------
    def close(self):
        """Drain and stop every stage in THE documented order (ckpt
        writer -> telemetry flush; docs/stages.md), then release the
        preemption hook and the GC finalizer.  Idempotent.  A close-time
        failure never aborts the drain mid-order: every stage still
        closes, the errors land in ``stage_errors``/``last_stage_error``,
        and the FIRST one re-raises."""
        self._pending_micros = []
        try:
            self.stop_profiler()  # no-op unless a window is open
        except Exception:
            pass
        try:
            self._anomaly_stop()  # a trigger-opened capture must land
        except Exception:
            pass
        finish_close(self)

    # ------------------------------------------------------------------
    # introspection / logging
    # ------------------------------------------------------------------
    @property
    def last_metrics(self) -> Optional[StepMetrics]:
        """The last step's metrics, read back from the card (the sync)."""
        if self._last_metrics is None and self._last_packed is not None:
            vec = self._last_packed.tolist()
            self._last_metrics = StepMetrics(
                loss=vec[0], grad_norm=vec[1], loss_scale=vec[2],
                overflow=vec[3] > 0.5, lr=vec[4])
        return self._last_metrics

    @property
    def lr_scheduler(self):
        """The resolved step→lr callable (config- or client-provided)."""
        return self._lr_schedule

    def train(self, mode: bool = True):
        self._train_mode = bool(mode)
        return self

    def eval(self):
        return self.train(False)

    def get_lr(self) -> float:
        if self._lr_schedule is not None:
            applied = self.global_steps - self.get_skipped_steps()
            return float(self._lr_schedule(applied))
        return float(self.config.optimizer_params.get("lr", 1e-3))

    def get_loss_scale(self) -> float:
        return float(self.state.scaler.loss_scale)

    def get_skipped_steps(self) -> int:
        return int(self.state.skipped_steps)

    def _report(self, metrics: StepMetrics):
        now = time.time()
        last = getattr(self, "_last_report", None)
        steps = self.global_steps - getattr(self, "_last_report_step", 0)
        self._last_report = now
        self._last_report_step = self.global_steps
        if last is not None and steps > 0:
            avg = (now - last) / steps
        else:  # first report: enqueue-biased
            avg = sum(self._step_times) / max(len(self._step_times), 1)
        tput = self.train_batch_size / avg if avg > 0 else 0.0
        log_dist(
            f"step={self.global_steps} loss={metrics.loss:.4f} "
            f"lr={metrics.lr:.3e} loss_scale={metrics.loss_scale:.1f} "
            f"skipped={self.get_skipped_steps()} "
            f"samples/sec={tput:.1f}", ranks=[0])


def _drain_tb_pending(pending, writer):
    """Flush buffered (step, packed metrics) records into the summary
    writer.  Mutates ``pending`` IN PLACE (clear, not rebind) so the GC
    finalizer — which holds the same list object — always sees the live
    buffer."""
    for step, rec in pending:
        if isinstance(rec, StepMetrics):
            loss, lr, scale = rec.loss, rec.lr, rec.loss_scale
        else:
            vec = rec.tolist()
            loss, lr, scale = vec[0], vec[4], vec[2]
        writer.add_scalar("Train/loss", float(loss), step)
        writer.add_scalar("Train/lr", float(lr), step)
        writer.add_scalar("Train/loss_scale", float(scale), step)
    pending.clear()


def _close_quietly(objs, tb_pending=None, writer=None):
    """GC-finalizer body: drain buffered scalars, then close the
    checkpoint writer and the observability outputs.  Never raises (it
    runs during interpreter shutdown)."""
    try:
        if tb_pending and writer is not None:
            _drain_tb_pending(tb_pending, writer)
    except Exception:
        pass
    for obj in objs:
        try:
            obj.close()
        except Exception:
            pass
