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

Scope: ZeRO stage 0 on one device, fp32/bf16/fp16 (dynamic loss scale
with hysteresis, skip on overflow), clipping, Adam/AdamW or LAMB, the
four lr schedules, progressive layer drop (θ advanced each step and put
into every micro-batch dict as a host float), ``eval_batch`` and the
forward/backward/step facade.  The
``data_prefetch`` block (on by default) runs inline here: the batch is
moved to the card inside ``train_batch``, a device tensor passes
straight through.

Checkpoints (``save_checkpoint``/``load_checkpoint``,
``runtime/checkpointing.py``) are the JAX package's on-disk format: the
``checkpoint`` block's async saves run on a daemon writer that ``close()``
drains, and ``checkpoint.sigterm_save`` installs the preemption hook, its
save deferred to the step boundary when the signal lands inside
``train_batch``.  Every other config knob whose path is not ported
raises ``NotImplementedError`` naming its ROADMAP.md item.
"""
from __future__ import annotations

import time
import weakref
from typing import Any, Callable, List, NamedTuple, Optional

import numpy as np
import torch

from ..config import constants as C
from ..utils.logging import log_dist, logger
from . import precision
from .dataloader import DeepSpeedDataLoader, supports_iter_state
from .engine_stages import close_ckpt_stage
from .lr_schedules import get_lr_schedule
from .resilience import AsyncCheckpointWriter
from .stages import Stage
from .utils import clip_by_global_norm, fold_in, global_norm, tree_leaves
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


def refuse_unported(config, optimizer=None, mesh=None) -> None:
    """Raise on every config knob whose training path this port does not
    run yet (defaults never raise)."""
    if mesh is not None:
        raise _unported("a device mesh", "item 9 (data/tensor parallel)")
    if config.world_size != 1:
        raise _unported(f"world_size={config.world_size} (dp > 1)",
                        "item 9 (data/tensor parallel)")
    zc = config.zero_config
    if zc.cpu_offload:
        raise _unported("zero_optimization.cpu_offload",
                        "item 12 (offload and input pipeline)")
    if config.zero_optimization_stage > 0 or zc.pg_correctness_test:
        raise _unported(
            f"zero_optimization.stage={config.zero_optimization_stage}",
            "item 9 (data/tensor parallel and ZeRO 1-3)")
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
    for what, on in (("telemetry.enabled", config.telemetry_config.enabled),
                     ("tensorboard.enabled",
                      config.tensorboard_config.enabled),
                     ("profiler.enabled", config.profiler_config.enabled),
                     ("wall_clock_breakdown", config.wall_clock_breakdown)):
        if on:
            raise _unported(what, "item 5, the training half (telemetry "
                            "and utils)")


def resolve_device(device) -> torch.device:
    """``cuda:0`` by default; raises without CUDA unless the caller names
    a device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "DeepSpeedEngine trains on the card by default and found no "
                "CUDA device; pass device='cpu' to train on the CPU")
        return torch.device("cuda", 0)
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
                 device=None):
        refuse_unported(config, optimizer)
        self.module = model
        self.config = config
        self.device = resolve_device(device)
        self.dp_world_size = 1
        self.compute_dtype = precision.select_compute_dtype(
            config.fp16_enabled, config.bf16_enabled)
        self.micro_batch_size = _CallableInt(
            config.train_micro_batch_size_per_gpu)
        self.gradient_accumulation_steps = _CallableInt(
            config.gradient_accumulation_steps)
        self.train_batch_size = _CallableInt(config.train_batch_size)

        self._lr_schedule = self._resolve_lr_schedule(lr_schedule)
        self.optimizer = (optimizer if optimizer is not None
                          else self._build_basic_optimizer())
        self.progressive_layer_drop = (
            ProgressiveLayerDrop(theta=config.pld_config.theta,
                                 gamma=config.pld_config.gamma)
            if config.pld_config.enabled else None)
        clip = config.gradient_clipping
        self.gradient_clipping = _CallableFloat(
            float(clip) if clip and clip > 0 else 0.0)

        if params is None:
            params = model.init(seed, device=self.device)
        master = _tree_map(lambda x: _master_leaf(x, self.device), params)
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
        self._init_checkpointing(config)
        log_dist(
            f"DeepSpeedEngine: device={self.device} zero_stage=0 "
            f"dtype={self.compute_dtype} "
            f"micro_bs={self.micro_batch_size} "
            f"grad_acc={self.gradient_accumulation_steps}", ranks=[0])

    def _init_checkpointing(self, config) -> None:
        """The async checkpoint writer (its thread starts with the first
        async save) under its ``ckpt_writer`` stage record — a writer
        that exhausts the stage's failure budget degrades to synchronous
        saves — and the opt-in SIGTERM preemption hook."""
        self._ckpt_stage = Stage(
            "ckpt_writer",
            max_failures=config.stages_config.max_stage_failures,
            fallback="synchronous saves")
        self._ckpt_writer = AsyncCheckpointWriter(stage=self._ckpt_stage)
        # a dropped engine's in-flight save still lands
        self._finalizer = weakref.finalize(self, self._ckpt_writer.close)
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
                              min_coeff=params.pop("min_coeff", 0.01))
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
    def _scaled_grads(self, batch, scaler, step_rng):
        """Accumulate fp32 grads of the scaled micro-batch losses on the
        master and unscale by ``loss_scale * grad_acc``.  Returns (grads in
        tree_leaves order, scaled losses)."""
        master = self.state.master_params
        leaves = tree_leaves(master)
        ga = int(self.gradient_accumulation_steps)
        scaled_losses = []
        for p in leaves:
            p.requires_grad_(True)
        try:
            for i in range(ga):
                mb = _tree_map(lambda x: x[i], batch)
                if self.progressive_layer_drop is not None \
                        and isinstance(mb, dict):
                    # a host float: the model's layer draws never sync
                    mb["pld_theta"] = self.progressive_layer_drop.get_theta()
                params = precision.cast_to_compute(master,
                                                   self.compute_dtype)
                loss = self.module.loss_fn(params, mb, fold_in(step_rng, i),
                                           train=True)
                scaled = precision.scale_loss(loss.float(), scaler)
                scaled.backward()
                scaled_losses.append(scaled.detach())
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in leaves]
        finally:
            for p in leaves:
                p.grad = None
                p.requires_grad_(False)
        inv = (1.0 / (scaler.loss_scale * ga)).float()
        return [g * inv for g in grads], scaled_losses

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
            finite = precision.grads_finite(grads)
            grad_norm = global_norm(grads)
            if self.gradient_clipping > 0:
                grads, _ = clip_by_global_norm(grads, self.gradient_clipping,
                                               norm=grad_norm)
        new_opt = self._apply_update(grads, finite)
        with torch.no_grad():
            mean_loss = torch.stack(scaled_losses).mean() / scaler.loss_scale
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
        return DeepSpeedDataLoader(
            dataset, batch_size=batch_size or self.train_batch_size,
            collate_fn=collate_fn)

    def _to_device(self, x) -> torch.Tensor:
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
            np.asarray(x))
        return t.to(self.device, non_blocking=True)

    def _place_train_batch(self, batch):
        """[train_batch, ...] leaves → [grad_acc, micro, ...] on the card."""
        ga, mb = int(self.gradient_accumulation_steps), int(
            self.micro_batch_size)

        def place(x):
            t = self._to_device(x)
            if t.shape[0] != ga * mb:
                raise ValueError(
                    f"batch dim {t.shape[0]} != train_batch_size "
                    f"{ga * mb} (grad_acc {ga} × micro {mb} × dp 1)")
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
        is whole again."""
        self._in_step = True
        try:
            return self._train_batch_inner(batch, data_iter)
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
        packed = self._train_step(self._place_train_batch(batch))
        self._last_packed = packed
        self._last_metrics = None
        self.global_steps += 1
        self.micro_steps += int(self.gradient_accumulation_steps)
        # enqueue time only: the synced rate comes from _report's interval
        self._step_times = (self._step_times + [time.time() - t0])[-10:]
        if self.global_steps % self.config.steps_per_print == 0:
            self._report(self.last_metrics)
        return packed[0]

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
            params = precision.cast_to_compute(self.state.master_params,
                                               self.compute_dtype)
            return self.module.loss_fn(
                params, micro, fold_in(self._data_rng, self.micro_steps),
                train=False)

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
            async_write = not self._ckpt_stage.degraded
        from .checkpointing import save_checkpoint
        out = save_checkpoint(self, save_dir, tag=tag,
                              client_state=client_state,
                              save_latest=save_latest,
                              async_write=bool(async_write))
        self._ckpt_last_save_dir = save_dir
        return out

    def load_checkpoint(self, load_dir, tag=None,
                        load_optimizer_states=True,
                        load_lr_scheduler_states=True,
                        load_module_only=False):
        """Restore a checkpoint this package or the JAX package wrote;
        returns ``(load_path, client_state)``, ``(None, None)`` when
        ``load_dir`` holds no ``latest``."""
        from .checkpointing import load_checkpoint
        return load_checkpoint(
            self, load_dir, tag=tag,
            load_optimizer_states=load_optimizer_states,
            load_lr_scheduler_states=load_lr_scheduler_states,
            load_module_only=load_module_only)

    def _canonical_state(self):
        """(master, optimizer state) in the JAX engine's tree form: the
        count and the moments re-nested onto the param tree."""
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
        that save; training continues and the next save retries)."""
        err = self._ckpt_writer.pop_error()
        if err is not None:
            self.last_ckpt_error = err

    def close(self):
        """Drain the async checkpoint writer (a save that fails while it
        drains lands in ``last_ckpt_error``), release the preemption
        hook; idempotent."""
        self._pending_micros = []
        close_ckpt_stage(self)
        ph = self._preemption_handler
        if ph is not None and not ph.fired:
            ph.uninstall()
        self._finalizer.detach()

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
