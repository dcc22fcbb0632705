"""ds_config.json → typed config.

Behavioral contract mirrors the reference parser
(reference: deepspeed/runtime/config.py:485-694): same key surface, the
batch-size triangle solver ``train_batch = micro_batch × grad_acc ×
world_size`` (config.py:586-636 there), duplicate-JSON-key rejection
(config_utils.py there), and the same sanity checks — re-expressed as
plain dataclass-style objects with no torch anywhere.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Optional

from . import constants as C
from ..utils.logging import logger


class DeepSpeedConfigError(Exception):
    pass


def _dict_raise_error_on_duplicate_keys(ordered_pairs):
    """Reject duplicate top-level keys instead of silently last-wins."""
    d = dict(ordered_pairs)
    if len(d) != len(ordered_pairs):
        counts = {}
        for k, _ in ordered_pairs:
            counts[k] = counts.get(k, 0) + 1
        dupes = [k for k, n in counts.items() if n > 1]
        raise DeepSpeedConfigError(f"Duplicate keys in DeepSpeed config: {dupes}")
    return d


def get_scalar_param(d: Dict, key: str, default):
    return d.get(key, default) if d is not None else default


class DeepSpeedZeroConfig:
    """ZeRO block. Accepts both the dict form and the deprecated bool form
    (reference: deepspeed/runtime/zero/config.py:34-47)."""

    def __init__(self, param_dict: Dict[str, Any]):
        zero = param_dict.get(C.ZERO_OPTIMIZATION, None)
        if zero is None:
            zero = {}
        elif isinstance(zero, bool):  # deprecated style: "zero_optimization": true
            logger.warning(
                "zero_optimization boolean form is deprecated; use {'stage': n}"
            )
            zero = {C.ZERO_STAGE: 1 if zero else 0}
        if not isinstance(zero, dict):
            raise DeepSpeedConfigError(
                f"{C.ZERO_OPTIMIZATION} must be a dict or bool, got {type(zero)}"
            )
        self.stage = get_scalar_param(zero, C.ZERO_STAGE, C.ZERO_STAGE_DEFAULT)
        self.allgather_partitions = get_scalar_param(
            zero, C.ZERO_ALLGATHER_PARTITIONS, C.ZERO_ALLGATHER_PARTITIONS_DEFAULT)
        self.reduce_scatter = get_scalar_param(
            zero, C.ZERO_REDUCE_SCATTER, C.ZERO_REDUCE_SCATTER_DEFAULT)
        self.overlap_comm = get_scalar_param(
            zero, C.ZERO_OVERLAP_COMM, C.ZERO_OVERLAP_COMM_DEFAULT)
        self.contiguous_gradients = get_scalar_param(
            zero, C.ZERO_CONTIGUOUS_GRADIENTS, C.ZERO_CONTIGUOUS_GRADIENTS_DEFAULT)
        self.reduce_bucket_size = get_scalar_param(
            zero, C.ZERO_REDUCE_BUCKET_SIZE, C.ZERO_REDUCE_BUCKET_SIZE_DEFAULT)
        self.allgather_bucket_size = get_scalar_param(
            zero, C.ZERO_ALLGATHER_BUCKET_SIZE, C.ZERO_ALLGATHER_BUCKET_SIZE_DEFAULT)
        self.max_elements_per_comm = get_scalar_param(
            zero, C.ZERO_MAX_ELEMENTS_PER_COMM, C.ZERO_MAX_ELEMENTS_PER_COMM_DEFAULT)
        self.cpu_offload = get_scalar_param(
            zero, C.ZERO_CPU_OFFLOAD, C.ZERO_CPU_OFFLOAD_DEFAULT)
        self.offload_impl = get_scalar_param(
            zero, C.ZERO_OFFLOAD_IMPL, C.ZERO_OFFLOAD_IMPL_DEFAULT)
        self.offload_grad_chunks = get_scalar_param(
            zero, C.ZERO_OFFLOAD_GRAD_CHUNKS,
            C.ZERO_OFFLOAD_GRAD_CHUNKS_DEFAULT)
        self.delayed_param_update = get_scalar_param(
            zero, C.ZERO_DELAYED_PARAM_UPDATE,
            C.ZERO_DELAYED_PARAM_UPDATE_DEFAULT)
        self.param_streaming = get_scalar_param(
            zero, C.ZERO_PARAM_STREAMING, C.ZERO_PARAM_STREAMING_DEFAULT)
        self.offload_split_update = get_scalar_param(
            zero, C.ZERO_OFFLOAD_SPLIT_UPDATE,
            C.ZERO_OFFLOAD_SPLIT_UPDATE_DEFAULT)
        self.offload_pipeline = get_scalar_param(
            zero, C.ZERO_OFFLOAD_PIPELINE,
            C.ZERO_OFFLOAD_PIPELINE_DEFAULT)
        # default-True knob: only an EXPLICIT offload_pipeline entry is
        # validated against cpu_offload (the default must not make every
        # non-offload config invalid); explicit false is always allowed
        self.offload_pipeline_explicit = C.ZERO_OFFLOAD_PIPELINE in zero
        if (not isinstance(self.offload_grad_chunks, int)
                or self.offload_grad_chunks < 1):
            raise DeepSpeedConfigError(
                f"{C.ZERO_OFFLOAD_GRAD_CHUNKS} must be an int >= 1, "
                f"got {self.offload_grad_chunks!r}")
        self.elastic_checkpoint = get_scalar_param(
            zero, C.ZERO_ELASTIC_CHECKPOINT, C.ZERO_ELASTIC_CHECKPOINT_DEFAULT)
        self.pg_correctness_test = get_scalar_param(
            zero, C.ZERO_PG_CORRECTNESS_TEST,
            C.ZERO_PG_CORRECTNESS_TEST_DEFAULT)
        if self.offload_impl not in ("auto", "xla", "host"):
            raise DeepSpeedConfigError(
                f"{C.ZERO_OFFLOAD_IMPL} must be 'auto', 'xla', or 'host', "
                f"got {self.offload_impl!r}")

        if not isinstance(self.stage, int) or not (
                C.ZERO_OPTIMIZATION_DISABLED <= self.stage <= C.MAX_STAGE_ZERO_OPTIMIZATION):
            raise DeepSpeedConfigError(
                f"ZeRO stage must be an int in [0, {C.MAX_STAGE_ZERO_OPTIMIZATION}], "
                f"got {self.stage!r}")

    def repr_dict(self):
        return {
            C.ZERO_STAGE: self.stage,
            C.ZERO_ALLGATHER_PARTITIONS: self.allgather_partitions,
            C.ZERO_REDUCE_SCATTER: self.reduce_scatter,
            C.ZERO_OVERLAP_COMM: self.overlap_comm,
            C.ZERO_CONTIGUOUS_GRADIENTS: self.contiguous_gradients,
            C.ZERO_REDUCE_BUCKET_SIZE: self.reduce_bucket_size,
            C.ZERO_ALLGATHER_BUCKET_SIZE: self.allgather_bucket_size,
            C.ZERO_CPU_OFFLOAD: self.cpu_offload,
            C.ZERO_ELASTIC_CHECKPOINT: self.elastic_checkpoint,
        }


class DeepSpeedActivationCheckpointingConfig:
    """Activation-checkpointing block → remat policy knobs
    (reference: deepspeed/runtime/activation_checkpointing/config.py)."""

    def __init__(self, param_dict: Dict[str, Any]):
        act = param_dict.get(C.ACTIVATION_CHECKPOINTING) or {}
        self.partition_activations = get_scalar_param(
            act, C.ACT_CKPT_PARTITION_ACTIVATIONS,
            C.ACT_CKPT_PARTITION_ACTIVATIONS_DEFAULT)
        self.contiguous_memory_optimization = get_scalar_param(
            act, C.ACT_CKPT_CONTIGUOUS_MEMORY_OPTIMIZATION,
            C.ACT_CKPT_CONTIGUOUS_MEMORY_OPTIMIZATION_DEFAULT)
        self.cpu_checkpointing = get_scalar_param(
            act, C.ACT_CKPT_CPU_CHECKPOINTING, C.ACT_CKPT_CPU_CHECKPOINTING_DEFAULT)
        self.number_checkpoints = get_scalar_param(
            act, C.ACT_CKPT_NUMBER_CHECKPOINTS, C.ACT_CKPT_NUMBER_CHECKPOINTS_DEFAULT)
        self.synchronize_checkpoint_boundary = get_scalar_param(
            act, C.ACT_CKPT_SYNCHRONIZE_CHECKPOINT_BOUNDARY,
            C.ACT_CKPT_SYNCHRONIZE_CHECKPOINT_BOUNDARY_DEFAULT)
        self.profile = get_scalar_param(
            act, C.ACT_CKPT_PROFILE, C.ACT_CKPT_PROFILE_DEFAULT)


class DeepSpeedFP16Config:
    def __init__(self, param_dict: Dict[str, Any]):
        fp16 = param_dict.get(C.FP16) or {}
        self.enabled = get_scalar_param(fp16, C.FP16_ENABLED, C.FP16_ENABLED_DEFAULT)
        self.loss_scale = get_scalar_param(
            fp16, C.FP16_LOSS_SCALE, C.FP16_LOSS_SCALE_DEFAULT)
        self.initial_scale_power = get_scalar_param(
            fp16, C.FP16_INITIAL_SCALE_POWER, C.FP16_INITIAL_SCALE_POWER_DEFAULT)
        self.loss_scale_window = get_scalar_param(
            fp16, C.FP16_LOSS_SCALE_WINDOW, C.FP16_LOSS_SCALE_WINDOW_DEFAULT)
        self.hysteresis = get_scalar_param(
            fp16, C.FP16_HYSTERESIS, C.FP16_HYSTERESIS_DEFAULT)
        self.min_loss_scale = get_scalar_param(
            fp16, C.FP16_MIN_LOSS_SCALE, C.FP16_MIN_LOSS_SCALE_DEFAULT)

    @property
    def dynamic_loss_scale(self) -> bool:
        return self.loss_scale == 0

    @property
    def initial_dynamic_scale(self) -> float:
        return 2 ** self.initial_scale_power


class DeepSpeedBF16Config:
    """TPU-native precision block (extension; bf16 needs no loss scale)."""

    def __init__(self, param_dict: Dict[str, Any]):
        bf16 = param_dict.get(C.BF16) or {}
        self.enabled = get_scalar_param(bf16, C.BF16_ENABLED, C.BF16_ENABLED_DEFAULT)


class DeepSpeedSparseAttentionConfig:
    def __init__(self, param_dict: Dict[str, Any]):
        sa = param_dict.get(C.SPARSE_ATTENTION)
        self.enabled = sa is not None
        self.params: Optional[Dict[str, Any]] = dict(sa) if sa else None
        if sa is not None:
            mode = sa.get(C.SPARSE_MODE, C.SPARSE_MODE_DEFAULT)
            valid = {C.SPARSE_DENSE_MODE, C.SPARSE_FIXED_MODE, C.SPARSE_VARIABLE_MODE,
                     C.SPARSE_BIGBIRD_MODE, C.SPARSE_BSLONGFORMER_MODE}
            if mode not in valid:
                raise DeepSpeedConfigError(f"Invalid sparse attention mode {mode!r}")
            self.mode = mode
            # Per-mode layout knobs — routed with their schema defaults so
            # downstream kernels never re-spell fallback values.
            self.block = get_scalar_param(
                sa, C.SPARSE_BLOCK, C.SPARSE_BLOCK_DEFAULT)
            self.different_layout_per_head = get_scalar_param(
                sa, C.SPARSE_DIFFERENT_LAYOUT_PER_HEAD,
                C.SPARSE_DIFFERENT_LAYOUT_PER_HEAD_DEFAULT)
            self.num_local_blocks = get_scalar_param(
                sa, C.SPARSE_NUM_LOCAL_BLOCKS, C.SPARSE_NUM_LOCAL_BLOCKS_DEFAULT)
            self.num_global_blocks = get_scalar_param(
                sa, C.SPARSE_NUM_GLOBAL_BLOCKS, C.SPARSE_NUM_GLOBAL_BLOCKS_DEFAULT)
            self.attention = get_scalar_param(
                sa, C.SPARSE_ATTENTION_TYPE, C.SPARSE_ATTENTION_TYPE_DEFAULT)
            self.horizontal_global_attention = get_scalar_param(
                sa, C.SPARSE_HORIZONTAL_GLOBAL_ATTENTION,
                C.SPARSE_HORIZONTAL_GLOBAL_ATTENTION_DEFAULT)
            self.num_different_global_patterns = get_scalar_param(
                sa, C.SPARSE_NUM_DIFFERENT_GLOBAL_PATTERNS,
                C.SPARSE_NUM_DIFFERENT_GLOBAL_PATTERNS_DEFAULT)
            self.num_random_blocks = get_scalar_param(
                sa, C.SPARSE_NUM_RANDOM_BLOCKS, C.SPARSE_NUM_RANDOM_BLOCKS_DEFAULT)
            self.local_window_blocks = get_scalar_param(
                sa, C.SPARSE_LOCAL_WINDOW_BLOCKS,
                C.SPARSE_LOCAL_WINDOW_BLOCKS_DEFAULT)
            self.global_block_indices = get_scalar_param(
                sa, C.SPARSE_GLOBAL_BLOCK_INDICES,
                C.SPARSE_GLOBAL_BLOCK_INDICES_DEFAULT)
            self.global_block_end_indices = get_scalar_param(
                sa, C.SPARSE_GLOBAL_BLOCK_END_INDICES,
                C.SPARSE_GLOBAL_BLOCK_END_INDICES_DEFAULT)
            self.num_sliding_window_blocks = get_scalar_param(
                sa, C.SPARSE_NUM_SLIDING_WINDOW_BLOCKS,
                C.SPARSE_NUM_SLIDING_WINDOW_BLOCKS_DEFAULT)
        else:
            self.mode = None


class DeepSpeedPLDConfig:
    def __init__(self, param_dict: Dict[str, Any]):
        pld = param_dict.get(C.PROGRESSIVE_LAYER_DROP) or {}
        self.enabled = get_scalar_param(pld, C.PLD_ENABLED, C.PLD_ENABLED_DEFAULT)
        self.theta = get_scalar_param(pld, C.PLD_THETA, C.PLD_THETA_DEFAULT)
        self.gamma = get_scalar_param(pld, C.PLD_GAMMA, C.PLD_GAMMA_DEFAULT)


class DeepSpeedProfilerConfig:
    """xplane trace window: capture steps ``[start_step,
    start_step + num_steps)`` to ``output_path`` via jax.profiler."""

    def __init__(self, param_dict: Dict[str, Any]):
        prof = param_dict.get(C.PROFILER) or {}
        self.enabled = get_scalar_param(
            prof, C.PROFILER_ENABLED, C.PROFILER_ENABLED_DEFAULT)
        self.start_step = get_scalar_param(
            prof, C.PROFILER_START_STEP, C.PROFILER_START_STEP_DEFAULT)
        self.num_steps = get_scalar_param(
            prof, C.PROFILER_NUM_STEPS, C.PROFILER_NUM_STEPS_DEFAULT)
        self.output_path = get_scalar_param(
            prof, C.PROFILER_OUTPUT_PATH, C.PROFILER_OUTPUT_PATH_DEFAULT)
        if self.enabled and (self.start_step < 0 or self.num_steps < 1):
            raise DeepSpeedConfigError(
                f"profiler window invalid: start_step={self.start_step} "
                f"num_steps={self.num_steps}")


class DeepSpeedTensorboardConfig:
    def __init__(self, param_dict: Dict[str, Any]):
        tb = param_dict.get(C.TENSORBOARD) or {}
        self.enabled = get_scalar_param(
            tb, C.TENSORBOARD_ENABLED, C.TENSORBOARD_ENABLED_DEFAULT)
        self.output_path = get_scalar_param(
            tb, C.TENSORBOARD_OUTPUT_PATH, C.TENSORBOARD_OUTPUT_PATH_DEFAULT)
        self.job_name = get_scalar_param(
            tb, C.TENSORBOARD_JOB_NAME, C.TENSORBOARD_JOB_NAME_DEFAULT)


class DeepSpeedTelemetryConfig:
    """Unified telemetry block: metrics registry + span tracing +
    compile/memory instrumentation (docs/observability.md)."""

    def __init__(self, param_dict: Dict[str, Any]):
        tel = param_dict.get(C.TELEMETRY) or {}
        self.enabled = get_scalar_param(
            tel, C.TELEMETRY_ENABLED, C.TELEMETRY_ENABLED_DEFAULT)
        self.output_path = get_scalar_param(
            tel, C.TELEMETRY_OUTPUT_PATH, C.TELEMETRY_OUTPUT_PATH_DEFAULT)
        self.trace = get_scalar_param(
            tel, C.TELEMETRY_TRACE, C.TELEMETRY_TRACE_DEFAULT)
        self.compile_events = get_scalar_param(
            tel, C.TELEMETRY_COMPILE_EVENTS,
            C.TELEMETRY_COMPILE_EVENTS_DEFAULT)
        self.memory = get_scalar_param(
            tel, C.TELEMETRY_MEMORY, C.TELEMETRY_MEMORY_DEFAULT)
        self.recompile_storm_threshold = get_scalar_param(
            tel, C.TELEMETRY_STORM_THRESHOLD,
            C.TELEMETRY_STORM_THRESHOLD_DEFAULT)
        if (not isinstance(self.recompile_storm_threshold, int)
                or isinstance(self.recompile_storm_threshold, bool)
                or self.recompile_storm_threshold < 1):
            raise DeepSpeedConfigError(
                f"{C.TELEMETRY_STORM_THRESHOLD} must be an int >= 1, "
                f"got {self.recompile_storm_threshold!r}")
        self.heartbeat = get_scalar_param(
            tel, C.TELEMETRY_HEARTBEAT, C.TELEMETRY_HEARTBEAT_DEFAULT)
        self.heartbeat_dir = get_scalar_param(
            tel, C.TELEMETRY_HEARTBEAT_DIR,
            C.TELEMETRY_HEARTBEAT_DIR_DEFAULT)
        self.straggler_ratio = get_scalar_param(
            tel, C.TELEMETRY_STRAGGLER_RATIO,
            C.TELEMETRY_STRAGGLER_RATIO_DEFAULT)
        self.anomaly_ratio = get_scalar_param(
            tel, C.TELEMETRY_ANOMALY_RATIO,
            C.TELEMETRY_ANOMALY_RATIO_DEFAULT)
        if (not isinstance(self.anomaly_ratio, (int, float))
                or isinstance(self.anomaly_ratio, bool)
                or not (self.anomaly_ratio == 0
                        or self.anomaly_ratio > 1.0)):
            raise DeepSpeedConfigError(
                f"telemetry.{C.TELEMETRY_ANOMALY_RATIO} must be 0 "
                f"(disabled) or a number > 1.0 (it multiplies the "
                f"trailing median step time), got {self.anomaly_ratio!r}")
        if not isinstance(self.heartbeat, bool):
            # the async_save lesson: a JSON string like "false" is truthy
            raise DeepSpeedConfigError(
                f"telemetry.{C.TELEMETRY_HEARTBEAT} must be a bool, "
                f"got {self.heartbeat!r}")
        if not isinstance(self.heartbeat_dir, str):
            raise DeepSpeedConfigError(
                f"telemetry.{C.TELEMETRY_HEARTBEAT_DIR} must be a string "
                f"path, got {self.heartbeat_dir!r}")
        if (not isinstance(self.straggler_ratio, (int, float))
                or isinstance(self.straggler_ratio, bool)
                or not self.straggler_ratio > 1.0):
            raise DeepSpeedConfigError(
                f"telemetry.{C.TELEMETRY_STRAGGLER_RATIO} must be a "
                f"number > 1.0 (it multiplies the fleet median), got "
                f"{self.straggler_ratio!r}")


class DeepSpeedDataPrefetchConfig:
    """Asynchronous input pipeline block (docs/observability.md): a
    daemon worker prefetches + device-places batches through a bounded
    queue so the step loop never pays collate/H2D inline.  Default ON;
    ``DS_PREFETCH=0`` is the no-config escape hatch (resolved by the
    engine, not here — config objects stay env-independent)."""

    def __init__(self, param_dict: Dict[str, Any]):
        pf = param_dict.get(C.DATA_PREFETCH) or {}
        self.enabled = get_scalar_param(
            pf, C.DATA_PREFETCH_ENABLED, C.DATA_PREFETCH_ENABLED_DEFAULT)
        self.depth = get_scalar_param(
            pf, C.DATA_PREFETCH_DEPTH, C.DATA_PREFETCH_DEPTH_DEFAULT)
        if (not isinstance(self.depth, int)
                or isinstance(self.depth, bool) or self.depth < 1):
            raise DeepSpeedConfigError(
                f"{C.DATA_PREFETCH_DEPTH} must be an int >= 1, "
                f"got {self.depth!r}")


class DeepSpeedCheckpointConfig:
    """Fault-tolerant checkpointing block (docs/checkpointing.md): async
    background saves, ``keep_last_n`` retention, the corrupt-latest
    ``load_fallback`` chain, transient-I/O retry, and the opt-in SIGTERM
    preemption save.  All knobs validate eagerly — a typo'd retention
    policy must fail at config parse, not at the 40-hour mark when the
    first GC runs."""

    def __init__(self, param_dict: Dict[str, Any]):
        ck = param_dict.get(C.CHECKPOINT) or {}
        self.async_save = get_scalar_param(
            ck, C.CKPT_ASYNC_SAVE, C.CKPT_ASYNC_SAVE_DEFAULT)
        self.keep_last_n = get_scalar_param(
            ck, C.CKPT_KEEP_LAST_N, C.CKPT_KEEP_LAST_N_DEFAULT)
        self.load_fallback = get_scalar_param(
            ck, C.CKPT_LOAD_FALLBACK, C.CKPT_LOAD_FALLBACK_DEFAULT)
        self.io_retry_attempts = get_scalar_param(
            ck, C.CKPT_IO_RETRY_ATTEMPTS, C.CKPT_IO_RETRY_ATTEMPTS_DEFAULT)
        self.io_retry_base_s = get_scalar_param(
            ck, C.CKPT_IO_RETRY_BASE_S, C.CKPT_IO_RETRY_BASE_S_DEFAULT)
        self.sigterm_save = get_scalar_param(
            ck, C.CKPT_SIGTERM_SAVE, C.CKPT_SIGTERM_SAVE_DEFAULT)
        self.save_dir = get_scalar_param(
            ck, C.CKPT_SAVE_DIR, C.CKPT_SAVE_DIR_DEFAULT)
        for name, v in ((C.CKPT_KEEP_LAST_N, self.keep_last_n),
                        (C.CKPT_LOAD_FALLBACK, self.load_fallback)):
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                raise DeepSpeedConfigError(
                    f"checkpoint.{name} must be an int >= 0, got {v!r}")
        if (not isinstance(self.io_retry_attempts, int)
                or isinstance(self.io_retry_attempts, bool)
                or self.io_retry_attempts < 1):
            raise DeepSpeedConfigError(
                f"checkpoint.{C.CKPT_IO_RETRY_ATTEMPTS} must be an int "
                f">= 1 (1 = no retry), got {self.io_retry_attempts!r}")
        if (not isinstance(self.io_retry_base_s, (int, float))
                or isinstance(self.io_retry_base_s, bool)
                or self.io_retry_base_s < 0):
            raise DeepSpeedConfigError(
                f"checkpoint.{C.CKPT_IO_RETRY_BASE_S} must be a number "
                f">= 0, got {self.io_retry_base_s!r}")
        if not isinstance(self.save_dir, str):
            raise DeepSpeedConfigError(
                f"checkpoint.{C.CKPT_SAVE_DIR} must be a string path, "
                f"got {self.save_dir!r}")
        for name, v in ((C.CKPT_ASYNC_SAVE, self.async_save),
                        (C.CKPT_SIGTERM_SAVE, self.sigterm_save)):
            # a JSON string like "false" is truthy — silently flipping
            # every save async (or installing the SIGTERM hook) is the
            # opposite of what was configured
            if not isinstance(v, bool):
                raise DeepSpeedConfigError(
                    f"checkpoint.{name} must be a bool, got {v!r}")


class DeepSpeedStagesConfig:
    """Shared async-stage runtime block (docs/stages.md): the
    per-stage consecutive-failure budget before graceful degradation.
    Validates eagerly — a typo'd budget must fail at config parse, not
    at the first transient fault mid-run."""

    def __init__(self, param_dict: Dict[str, Any]):
        sg = param_dict.get(C.STAGES) or {}
        self.max_stage_failures = get_scalar_param(
            sg, C.STAGES_MAX_FAILURES, C.STAGES_MAX_FAILURES_DEFAULT)
        if (not isinstance(self.max_stage_failures, int)
                or isinstance(self.max_stage_failures, bool)
                or self.max_stage_failures < 1):
            raise DeepSpeedConfigError(
                f"stages.{C.STAGES_MAX_FAILURES} must be an int >= 1 "
                f"(consecutive transient failures before a stage "
                f"degrades), got {self.max_stage_failures!r}")


class DeepSpeedOffloadConfig:
    """Offload-tier block (runtime/disk_offload.py, docs/stages.md):
    selects which tier holds the fp32 master + Adam moments under the
    host offload impl — host RAM ("host", the default) or per-leaf
    CRC'd files on disk ("disk", the ZeRO-Infinity bottom tier).
    Validates eagerly: a typo'd tier or a missing disk_dir must fail at
    config parse, not as a mid-run surprise after the first step."""

    def __init__(self, param_dict: Dict[str, Any]):
        off = param_dict.get(C.OFFLOAD) or {}
        if not isinstance(off, dict):
            raise DeepSpeedConfigError(
                f"{C.OFFLOAD} must be a dict, got {type(off)}")
        self.tier = get_scalar_param(
            off, C.OFFLOAD_TIER, C.OFFLOAD_TIER_DEFAULT)
        self.disk_dir = get_scalar_param(
            off, C.OFFLOAD_DISK_DIR, C.OFFLOAD_DISK_DIR_DEFAULT)
        self.io_depth = get_scalar_param(
            off, C.OFFLOAD_IO_DEPTH, C.OFFLOAD_IO_DEPTH_DEFAULT)
        self.fsync = get_scalar_param(
            off, C.OFFLOAD_FSYNC, C.OFFLOAD_FSYNC_DEFAULT)
        if self.tier not in ("host", "disk"):
            raise DeepSpeedConfigError(
                f"{C.OFFLOAD}.{C.OFFLOAD_TIER} must be 'host' or 'disk', "
                f"got {self.tier!r}")
        if (not isinstance(self.io_depth, int)
                or isinstance(self.io_depth, bool) or self.io_depth < 1):
            raise DeepSpeedConfigError(
                f"{C.OFFLOAD}.{C.OFFLOAD_IO_DEPTH} must be an int >= 1 "
                f"(bounded disk read-ahead/write-back depth), got "
                f"{self.io_depth!r}")
        if not isinstance(self.fsync, bool):
            raise DeepSpeedConfigError(
                f"{C.OFFLOAD}.{C.OFFLOAD_FSYNC} must be a bool, got "
                f"{self.fsync!r}")
        if self.tier == "disk":
            if not isinstance(self.disk_dir, str) or not self.disk_dir:
                raise DeepSpeedConfigError(
                    f"{C.OFFLOAD}.{C.OFFLOAD_TIER}='disk' requires "
                    f"{C.OFFLOAD}.{C.OFFLOAD_DISK_DIR} (the directory "
                    "holding the per-leaf master/moment state files)")
        elif self.disk_dir is not None and not isinstance(
                self.disk_dir, str):
            raise DeepSpeedConfigError(
                f"{C.OFFLOAD}.{C.OFFLOAD_DISK_DIR} must be a string path, "
                f"got {self.disk_dir!r}")


class DeepSpeedServingConfig:
    """Serving block (docs/serving.md): the static slot pool the
    KV-cached decode engine compiles ONE program against.  Everything
    validates eagerly — a typo'd slot count must fail at config parse,
    not as a silent recompile storm under production traffic."""

    def __init__(self, param_dict: Dict[str, Any]):
        sv = param_dict.get(C.SERVING) or {}
        self.slots = get_scalar_param(
            sv, C.SERVING_SLOTS, C.SERVING_SLOTS_DEFAULT)
        self.max_seq_len = get_scalar_param(
            sv, C.SERVING_MAX_SEQ_LEN, C.SERVING_MAX_SEQ_LEN_DEFAULT)
        self.prefill_len = get_scalar_param(
            sv, C.SERVING_PREFILL_LEN, C.SERVING_PREFILL_LEN_DEFAULT)
        self.decode_impl = get_scalar_param(
            sv, C.SERVING_DECODE_IMPL, C.SERVING_DECODE_IMPL_DEFAULT)
        self.queue_capacity = get_scalar_param(
            sv, C.SERVING_QUEUE_CAPACITY, C.SERVING_QUEUE_CAPACITY_DEFAULT)
        self.flush_interval_ticks = get_scalar_param(
            sv, C.SERVING_FLUSH_INTERVAL, C.SERVING_FLUSH_INTERVAL_DEFAULT)
        self.eos_id = get_scalar_param(
            sv, C.SERVING_EOS_ID, C.SERVING_EOS_ID_DEFAULT)
        self.page_len = get_scalar_param(
            sv, C.SERVING_PAGE_LEN, C.SERVING_PAGE_LEN_DEFAULT)
        self.pages = get_scalar_param(
            sv, C.SERVING_PAGES, C.SERVING_PAGES_DEFAULT)
        self.prefix_cache = get_scalar_param(
            sv, C.SERVING_PREFIX_CACHE, C.SERVING_PREFIX_CACHE_DEFAULT)
        self.speculate_k = get_scalar_param(
            sv, C.SERVING_SPECULATE_K, C.SERVING_SPECULATE_K_DEFAULT)
        self.temperature = get_scalar_param(
            sv, C.SERVING_TEMPERATURE, C.SERVING_TEMPERATURE_DEFAULT)
        self.prefill_chunk_len = get_scalar_param(
            sv, C.SERVING_PREFILL_CHUNK_LEN,
            C.SERVING_PREFILL_CHUNK_LEN_DEFAULT)
        self.draft = self._validate_draft(sv.get(C.SERVING_DRAFT))
        self.quantization = self._validate_quantization(
            sv.get(C.SERVING_QUANTIZATION), self.page_len)
        self.lora = self._validate_lora(
            sv.get(C.SERVING_LORA), self.page_len)
        self.kv_tier = self._validate_kv_tier(
            sv.get(C.SERVING_KV_TIER), self.page_len)
        for name, v, lo in ((C.SERVING_SLOTS, self.slots, 1),
                            (C.SERVING_MAX_SEQ_LEN, self.max_seq_len, 0),
                            (C.SERVING_PREFILL_LEN, self.prefill_len, 0),
                            (C.SERVING_PAGE_LEN, self.page_len, 0),
                            (C.SERVING_PAGES, self.pages, 0),
                            (C.SERVING_PREFILL_CHUNK_LEN,
                             self.prefill_chunk_len, 0),
                            (C.SERVING_QUEUE_CAPACITY,
                             self.queue_capacity, 1),
                            (C.SERVING_FLUSH_INTERVAL,
                             self.flush_interval_ticks, 1)):
            if not isinstance(v, int) or isinstance(v, bool) or v < lo:
                raise DeepSpeedConfigError(
                    f"serving.{name} must be an int >= {lo}, got {v!r}")
        if (self.max_seq_len and self.prefill_len
                and self.prefill_len > self.max_seq_len):
            raise DeepSpeedConfigError(
                f"serving.{C.SERVING_PREFILL_LEN}={self.prefill_len} "
                f"exceeds serving.{C.SERVING_MAX_SEQ_LEN}="
                f"{self.max_seq_len}: a prompt bucket longer than the KV "
                "capacity can never be admitted")
        if self.decode_impl not in ("auto", "pallas", "dense"):
            raise DeepSpeedConfigError(
                f"serving.{C.SERVING_DECODE_IMPL} must be 'auto', "
                f"'pallas', or 'dense', got {self.decode_impl!r}")
        if not isinstance(self.eos_id, int) or isinstance(self.eos_id, bool):
            raise DeepSpeedConfigError(
                f"serving.{C.SERVING_EOS_ID} must be an int token id "
                f"(-1 = none), got {self.eos_id!r}")
        # JSON "true"/"false" strings are truthy — a string here would
        # silently flip the prefix plane, the PR 5 async_save bug class
        if not isinstance(self.prefix_cache, bool):
            raise DeepSpeedConfigError(
                f"serving.{C.SERVING_PREFIX_CACHE} must be a bool, got "
                f"{self.prefix_cache!r}")
        if self.pages and not self.page_len:
            raise DeepSpeedConfigError(
                f"serving.{C.SERVING_PAGES}={self.pages} needs "
                f"serving.{C.SERVING_PAGE_LEN} > 0 (pages size a paged "
                "pool; page_len=0 is the pre-page slot cache)")
        if self.page_len and self.pages and self.pages < 2:
            raise DeepSpeedConfigError(
                f"serving.{C.SERVING_PAGES}={self.pages} is too small: "
                "page 0 is the reserved scratch page, so a usable pool "
                "needs at least 2 pages (0 = auto-size)")
        if self.prefill_chunk_len and not self.page_len:
            raise DeepSpeedConfigError(
                f"serving.{C.SERVING_PREFILL_CHUNK_LEN}="
                f"{self.prefill_chunk_len} needs serving."
                f"{C.SERVING_PAGE_LEN} > 0: chunked prefill rides the "
                "delta-aware paged prefill program (the slot layout "
                "prefills whole prompts)")
        if not isinstance(self.speculate_k, int) \
                or isinstance(self.speculate_k, bool) \
                or self.speculate_k < 0:
            raise DeepSpeedConfigError(
                f"serving.{C.SERVING_SPECULATE_K} must be an int >= 0 "
                f"(0 = speculation off), got {self.speculate_k!r}")
        if isinstance(self.temperature, bool) \
                or not isinstance(self.temperature, (int, float)) \
                or self.temperature < 0:
            raise DeepSpeedConfigError(
                f"serving.{C.SERVING_TEMPERATURE} must be a number >= 0 "
                f"(0 = greedy), got {self.temperature!r}")
        self.temperature = float(self.temperature)

    @staticmethod
    def _validate_draft(draft) -> Dict[str, Any]:
        """Eager validation of the ``serving.draft`` block: a typo'd
        draft dimension must fail at config parse, not as a shape error
        inside the first verify pass.  Returns the block with defaults
        filled (vocab_size/n_positions are the ENGINE's to force from
        the target model — they are rejected here)."""
        if draft is None:
            draft = {}
        if not isinstance(draft, dict):
            raise DeepSpeedConfigError(
                f"serving.{C.SERVING_DRAFT} must be a dict of draft-"
                f"model dimensions, got {draft!r}")
        allowed = {C.SERVING_DRAFT_D_MODEL, C.SERVING_DRAFT_N_LAYER,
                   C.SERVING_DRAFT_N_HEAD, C.SERVING_DRAFT_ATTN_IMPL}
        unknown = set(draft) - allowed
        if unknown:
            raise DeepSpeedConfigError(
                f"serving.{C.SERVING_DRAFT} has unknown key(s) "
                f"{sorted(unknown)}; allowed: {sorted(allowed)} "
                "(vocab_size/n_positions always follow the target "
                "model)")
        out = {
            C.SERVING_DRAFT_D_MODEL: get_scalar_param(
                draft, C.SERVING_DRAFT_D_MODEL,
                C.SERVING_DRAFT_D_MODEL_DEFAULT),
            C.SERVING_DRAFT_N_LAYER: get_scalar_param(
                draft, C.SERVING_DRAFT_N_LAYER,
                C.SERVING_DRAFT_N_LAYER_DEFAULT),
            C.SERVING_DRAFT_N_HEAD: get_scalar_param(
                draft, C.SERVING_DRAFT_N_HEAD,
                C.SERVING_DRAFT_N_HEAD_DEFAULT),
            C.SERVING_DRAFT_ATTN_IMPL: get_scalar_param(
                draft, C.SERVING_DRAFT_ATTN_IMPL,
                C.SERVING_DRAFT_ATTN_IMPL_DEFAULT),
        }
        for key in (C.SERVING_DRAFT_D_MODEL, C.SERVING_DRAFT_N_LAYER,
                    C.SERVING_DRAFT_N_HEAD):
            v = out[key]
            if not isinstance(v, int) or isinstance(v, bool) or v < 1:
                raise DeepSpeedConfigError(
                    f"serving.{C.SERVING_DRAFT}.{key} must be an int "
                    f">= 1, got {v!r}")
        if out[C.SERVING_DRAFT_D_MODEL] % out[C.SERVING_DRAFT_N_HEAD]:
            raise DeepSpeedConfigError(
                f"serving.{C.SERVING_DRAFT}: d_model="
                f"{out[C.SERVING_DRAFT_D_MODEL]} must be divisible by "
                f"n_head={out[C.SERVING_DRAFT_N_HEAD]}")
        if out[C.SERVING_DRAFT_ATTN_IMPL] not in ("", "flash", "dense"):
            raise DeepSpeedConfigError(
                f"serving.{C.SERVING_DRAFT}.{C.SERVING_DRAFT_ATTN_IMPL} "
                "must be '' (follow the target), 'flash', or 'dense', "
                f"got {out[C.SERVING_DRAFT_ATTN_IMPL]!r}")
        return out

    @staticmethod
    def _validate_quantization(quant, page_len: int) -> Dict[str, str]:
        """Eager validation of ``serving.quantization`` (docs/serving.md
        "quantized serving"): a typo'd arm must fail at config parse,
        not as a silent fp fallback under production traffic.  Returns
        the block with defaults filled ('fp16' = the master dtype as
        loaded — no cast, bitwise-unchanged programs)."""
        if quant is None:
            quant = {}
        if not isinstance(quant, dict):
            raise DeepSpeedConfigError(
                f"serving.{C.SERVING_QUANTIZATION} must be a dict "
                f"(weights/kv arms), got {quant!r}")
        allowed = {C.SERVING_QUANT_WEIGHTS, C.SERVING_QUANT_KV}
        unknown = set(quant) - allowed
        if unknown:
            raise DeepSpeedConfigError(
                f"serving.{C.SERVING_QUANTIZATION} has unknown key(s) "
                f"{sorted(unknown)}; allowed: {sorted(allowed)}")
        out = {
            C.SERVING_QUANT_WEIGHTS: get_scalar_param(
                quant, C.SERVING_QUANT_WEIGHTS,
                C.SERVING_QUANT_WEIGHTS_DEFAULT),
            C.SERVING_QUANT_KV: get_scalar_param(
                quant, C.SERVING_QUANT_KV, C.SERVING_QUANT_KV_DEFAULT),
        }
        for key in allowed:
            if out[key] not in ("fp16", "int8"):
                raise DeepSpeedConfigError(
                    f"serving.{C.SERVING_QUANTIZATION}.{key} must be "
                    f"'fp16' (the master dtype — no quantization) or "
                    f"'int8', got {out[key]!r}")
        if out[C.SERVING_QUANT_KV] == "int8" and not page_len:
            raise DeepSpeedConfigError(
                f"serving.{C.SERVING_QUANT_KV}='int8' requires serving."
                f"{C.SERVING_PAGE_LEN} > 0: quantized KV is a property "
                "of the paged pool (the slot layout keeps the master "
                "dtype)")
        if out[C.SERVING_QUANT_KV] == "int8" and page_len > 128:
            # the fused-dequant kernels ride one scale lane per stored
            # row (ops/pallas/decode_attention.py _scale_tile) — catch
            # the limit here, not as a trace error on the first decode
            # tick under live traffic
            raise DeepSpeedConfigError(
                f"serving.{C.SERVING_QUANT_KV}='int8' supports "
                f"serving.{C.SERVING_PAGE_LEN} <= 128 (one scale lane "
                f"per page row in the fused-dequant kernels), got "
                f"{page_len}")
        return out

    @staticmethod
    def _validate_lora(lora, page_len: int) -> Dict[str, Any]:
        """Eager validation of ``serving.lora`` (docs/serving.md
        "multi-tenant serving"): a typo'd rank or target must fail at
        config parse, not as a shape error inside the first decode tick
        under live multi-tenant traffic.  Returns the block with
        defaults filled (rank=0 = lora OFF — no pool, no extra
        operands, bitwise-unchanged programs)."""
        if lora is None:
            lora = {}
        if not isinstance(lora, dict):
            raise DeepSpeedConfigError(
                f"serving.{C.SERVING_LORA} must be a dict "
                f"(rank/alpha/max_adapters/hbm_adapter_slots/targets), "
                f"got {lora!r}")
        allowed = {C.SERVING_LORA_RANK, C.SERVING_LORA_ALPHA,
                   C.SERVING_LORA_MAX_ADAPTERS, C.SERVING_LORA_HBM_SLOTS,
                   C.SERVING_LORA_TARGETS}
        unknown = set(lora) - allowed
        if unknown:
            raise DeepSpeedConfigError(
                f"serving.{C.SERVING_LORA} has unknown key(s) "
                f"{sorted(unknown)}; allowed: {sorted(allowed)}")
        out = {
            C.SERVING_LORA_RANK: get_scalar_param(
                lora, C.SERVING_LORA_RANK, C.SERVING_LORA_RANK_DEFAULT),
            C.SERVING_LORA_ALPHA: get_scalar_param(
                lora, C.SERVING_LORA_ALPHA,
                C.SERVING_LORA_ALPHA_DEFAULT),
            C.SERVING_LORA_MAX_ADAPTERS: get_scalar_param(
                lora, C.SERVING_LORA_MAX_ADAPTERS,
                C.SERVING_LORA_MAX_ADAPTERS_DEFAULT),
            C.SERVING_LORA_HBM_SLOTS: get_scalar_param(
                lora, C.SERVING_LORA_HBM_SLOTS,
                C.SERVING_LORA_HBM_SLOTS_DEFAULT),
            C.SERVING_LORA_TARGETS: tuple(lora.get(
                C.SERVING_LORA_TARGETS, C.SERVING_LORA_TARGETS_DEFAULT)),
        }
        rank = out[C.SERVING_LORA_RANK]
        if not isinstance(rank, int) or isinstance(rank, bool) \
                or rank < 0:
            raise DeepSpeedConfigError(
                f"serving.{C.SERVING_LORA}.{C.SERVING_LORA_RANK} must "
                f"be an int >= 0 (0 = lora off), got {rank!r}")
        alpha = out[C.SERVING_LORA_ALPHA]
        if isinstance(alpha, bool) \
                or not isinstance(alpha, (int, float)) or alpha <= 0:
            raise DeepSpeedConfigError(
                f"serving.{C.SERVING_LORA}.{C.SERVING_LORA_ALPHA} must "
                f"be a number > 0 (the alpha/rank delta scale), got "
                f"{alpha!r}")
        out[C.SERVING_LORA_ALPHA] = float(alpha)
        for key in (C.SERVING_LORA_MAX_ADAPTERS,
                    C.SERVING_LORA_HBM_SLOTS):
            v = out[key]
            if not isinstance(v, int) or isinstance(v, bool) or v < 1:
                raise DeepSpeedConfigError(
                    f"serving.{C.SERVING_LORA}.{key} must be an int "
                    f">= 1, got {v!r}")
        target_names = ("qkv_w", "out_w", "fc_w", "proj_w")
        targets = out[C.SERVING_LORA_TARGETS]
        if not targets or any(t not in target_names for t in targets) \
                or len(set(targets)) != len(targets):
            raise DeepSpeedConfigError(
                f"serving.{C.SERVING_LORA}.{C.SERVING_LORA_TARGETS} "
                f"must be a non-empty list of distinct block-param "
                f"names from {list(target_names)}, got "
                f"{list(targets)!r}")
        if rank and not page_len:
            raise DeepSpeedConfigError(
                f"serving.{C.SERVING_LORA}.{C.SERVING_LORA_RANK}="
                f"{rank} requires serving.{C.SERVING_PAGE_LEN} > 0: "
                "the adapter pool rides the paged serving plane (its "
                "residency slots are managed exactly like KV pages)")
        return out

    @staticmethod
    def _validate_kv_tier(kv, page_len: int) -> Dict[str, Any]:
        """Eager validation of ``serving.kv_tier`` (docs/serving.md
        "KV tiering"): a typo'd budget or park threshold must fail at
        config parse, not as a silently-never-parking tier under live
        traffic.  Returns the block with defaults filled
        (idle_park_ticks=0 = tiering OFF — no tier object, no extra
        host copies, engine behavior bitwise unchanged)."""
        if kv is None:
            kv = {}
        if not isinstance(kv, dict):
            raise DeepSpeedConfigError(
                f"serving.{C.SERVING_KV_TIER} must be a dict "
                f"(idle_park_ticks/host_budget_pages/disk_dir/fsync), "
                f"got {kv!r}")
        allowed = {C.SERVING_KV_TIER_IDLE_PARK_TICKS,
                   C.SERVING_KV_TIER_HOST_BUDGET_PAGES,
                   C.SERVING_KV_TIER_DISK_DIR,
                   C.SERVING_KV_TIER_FSYNC}
        unknown = set(kv) - allowed
        if unknown:
            raise DeepSpeedConfigError(
                f"serving.{C.SERVING_KV_TIER} has unknown key(s) "
                f"{sorted(unknown)}; allowed: {sorted(allowed)}")
        out = {
            C.SERVING_KV_TIER_IDLE_PARK_TICKS: get_scalar_param(
                kv, C.SERVING_KV_TIER_IDLE_PARK_TICKS,
                C.SERVING_KV_TIER_IDLE_PARK_TICKS_DEFAULT),
            C.SERVING_KV_TIER_HOST_BUDGET_PAGES: get_scalar_param(
                kv, C.SERVING_KV_TIER_HOST_BUDGET_PAGES,
                C.SERVING_KV_TIER_HOST_BUDGET_PAGES_DEFAULT),
            C.SERVING_KV_TIER_DISK_DIR: get_scalar_param(
                kv, C.SERVING_KV_TIER_DISK_DIR,
                C.SERVING_KV_TIER_DISK_DIR_DEFAULT),
            C.SERVING_KV_TIER_FSYNC: get_scalar_param(
                kv, C.SERVING_KV_TIER_FSYNC,
                C.SERVING_KV_TIER_FSYNC_DEFAULT),
        }
        for key in (C.SERVING_KV_TIER_IDLE_PARK_TICKS,
                    C.SERVING_KV_TIER_HOST_BUDGET_PAGES):
            v = out[key]
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                raise DeepSpeedConfigError(
                    f"serving.{C.SERVING_KV_TIER}.{key} must be an "
                    f"int >= 0, got {v!r}")
        if not isinstance(out[C.SERVING_KV_TIER_DISK_DIR], str):
            raise DeepSpeedConfigError(
                f"serving.{C.SERVING_KV_TIER}."
                f"{C.SERVING_KV_TIER_DISK_DIR} must be a string "
                f"directory path ('' = no disk tier), got "
                f"{out[C.SERVING_KV_TIER_DISK_DIR]!r}")
        if not isinstance(out[C.SERVING_KV_TIER_FSYNC], bool):
            raise DeepSpeedConfigError(
                f"serving.{C.SERVING_KV_TIER}.{C.SERVING_KV_TIER_FSYNC} "
                f"must be a bool, got {out[C.SERVING_KV_TIER_FSYNC]!r}")
        if out[C.SERVING_KV_TIER_IDLE_PARK_TICKS] and not page_len:
            raise DeepSpeedConfigError(
                f"serving.{C.SERVING_KV_TIER}."
                f"{C.SERVING_KV_TIER_IDLE_PARK_TICKS}="
                f"{out[C.SERVING_KV_TIER_IDLE_PARK_TICKS]} requires "
                f"serving.{C.SERVING_PAGE_LEN} > 0: the KV tier parks "
                "prefix-cache pages, which exist only on the paged "
                "serving plane")
        return out


class DeepSpeedFleetConfig:
    """Serving-fleet block (docs/serving.md "serving fleet"): the
    router/autoscaler knobs over N ServeEngine replicas.  Validates
    eagerly — a typo'd SLO or an inverted min/max clamp must fail at
    config parse, not as a silent never-scaling fleet under live
    traffic."""

    def __init__(self, param_dict: Dict[str, Any]):
        fl = param_dict.get(C.FLEET) or {}
        self.replicas = get_scalar_param(
            fl, C.FLEET_REPLICAS, C.FLEET_REPLICAS_DEFAULT)
        self.min_replicas = get_scalar_param(
            fl, C.FLEET_MIN_REPLICAS, C.FLEET_MIN_REPLICAS_DEFAULT)
        self.max_replicas = get_scalar_param(
            fl, C.FLEET_MAX_REPLICAS, C.FLEET_MAX_REPLICAS_DEFAULT)
        self.slo_p99_s = get_scalar_param(
            fl, C.FLEET_SLO_P99_S, C.FLEET_SLO_P99_S_DEFAULT)
        self.scale_up_window_s = get_scalar_param(
            fl, C.FLEET_SCALE_UP_WINDOW_S,
            C.FLEET_SCALE_UP_WINDOW_S_DEFAULT)
        self.scale_down_window_s = get_scalar_param(
            fl, C.FLEET_SCALE_DOWN_WINDOW_S,
            C.FLEET_SCALE_DOWN_WINDOW_S_DEFAULT)
        self.heartbeat_timeout_s = get_scalar_param(
            fl, C.FLEET_HEARTBEAT_TIMEOUT_S,
            C.FLEET_HEARTBEAT_TIMEOUT_S_DEFAULT)
        self.max_restarts = get_scalar_param(
            fl, C.FLEET_MAX_RESTARTS, C.FLEET_MAX_RESTARTS_DEFAULT)
        self.backoff_base_s = get_scalar_param(
            fl, C.FLEET_BACKOFF_BASE_S, C.FLEET_BACKOFF_BASE_S_DEFAULT)
        self.backoff_max_s = get_scalar_param(
            fl, C.FLEET_BACKOFF_MAX_S, C.FLEET_BACKOFF_MAX_S_DEFAULT)
        self.spawn_timeout_s = get_scalar_param(
            fl, C.FLEET_SPAWN_TIMEOUT_S, C.FLEET_SPAWN_TIMEOUT_S_DEFAULT)
        self.term_grace_s = get_scalar_param(
            fl, C.FLEET_TERM_GRACE_S, C.FLEET_TERM_GRACE_S_DEFAULT)
        self.slo_ttft_s = get_scalar_param(
            fl, C.FLEET_SLO_TTFT_S, C.FLEET_SLO_TTFT_S_DEFAULT)
        self.slo_tpot_s = get_scalar_param(
            fl, C.FLEET_SLO_TPOT_S, C.FLEET_SLO_TPOT_S_DEFAULT)
        self.roles = self._validate_roles(
            fl.get(C.FLEET_ROLES, C.FLEET_ROLES_DEFAULT))
        if self.roles is not None:
            # roles size the fleet; an explicit replicas count that
            # disagrees is a config contradiction, not a tiebreak
            if C.FLEET_REPLICAS in fl \
                    and fl[C.FLEET_REPLICAS] != sum(self.roles.values()):
                raise DeepSpeedConfigError(
                    f"fleet.{C.FLEET_REPLICAS}={fl[C.FLEET_REPLICAS]} "
                    f"contradicts fleet.{C.FLEET_ROLES}={self.roles} "
                    f"(role counts sum to {sum(self.roles.values())}); "
                    "drop one of them")
            self.replicas = sum(self.roles.values())
        for name, v in ((C.FLEET_REPLICAS, self.replicas),
                        (C.FLEET_MIN_REPLICAS, self.min_replicas),
                        (C.FLEET_MAX_REPLICAS, self.max_replicas)):
            if not isinstance(v, int) or isinstance(v, bool) or v < 1:
                raise DeepSpeedConfigError(
                    f"fleet.{name} must be an int >= 1, got {v!r}")
        if not (self.min_replicas <= self.replicas <= self.max_replicas):
            raise DeepSpeedConfigError(
                f"fleet replica clamps must nest: min_replicas="
                f"{self.min_replicas} <= replicas={self.replicas} <= "
                f"max_replicas={self.max_replicas}")
        for name, v, lo in (
                (C.FLEET_SLO_P99_S, self.slo_p99_s, 0.0),
                (C.FLEET_SCALE_UP_WINDOW_S, self.scale_up_window_s, 0.0),
                (C.FLEET_SCALE_DOWN_WINDOW_S,
                 self.scale_down_window_s, 0.0),
                (C.FLEET_BACKOFF_BASE_S, self.backoff_base_s, 0.0),
                (C.FLEET_BACKOFF_MAX_S, self.backoff_max_s, 0.0),
                (C.FLEET_SPAWN_TIMEOUT_S, self.spawn_timeout_s, 0.0),
                (C.FLEET_TERM_GRACE_S, self.term_grace_s, 0.0)):
            if isinstance(v, bool) or not isinstance(v, (int, float)) \
                    or v <= lo:
                raise DeepSpeedConfigError(
                    f"fleet.{name} must be a number > {lo}, got {v!r}")
        if isinstance(self.heartbeat_timeout_s, bool) or \
                not isinstance(self.heartbeat_timeout_s, (int, float)) \
                or self.heartbeat_timeout_s < 0:
            raise DeepSpeedConfigError(
                f"fleet.{C.FLEET_HEARTBEAT_TIMEOUT_S} must be a number "
                f">= 0 (0 = off), got {self.heartbeat_timeout_s!r}")
        if not isinstance(self.max_restarts, int) \
                or isinstance(self.max_restarts, bool) \
                or self.max_restarts < 0:
            raise DeepSpeedConfigError(
                f"fleet.{C.FLEET_MAX_RESTARTS} must be an int >= 0 "
                f"(consecutive no-progress replica failures before the "
                f"typed give-up), got {self.max_restarts!r}")
        for name, v in ((C.FLEET_SLO_TTFT_S, self.slo_ttft_s),
                        (C.FLEET_SLO_TPOT_S, self.slo_tpot_s)):
            if isinstance(v, bool) or not isinstance(v, (int, float)) \
                    or v < 0:
                raise DeepSpeedConfigError(
                    f"fleet.{name} must be a number >= 0 (0 = fall "
                    f"back to the queue-wait SLO), got {v!r}")

    @staticmethod
    def _validate_roles(roles):
        """Eager validation of ``fleet.roles`` (docs/serving.md
        "disaggregated fleet"): role name -> initial replica count.
        None = the homogeneous fleet (every replica "mixed").  A typo'd
        role must fail at config parse, not as a router that never
        finds a decode replica to migrate to."""
        if roles is None:
            return None
        if not isinstance(roles, dict) or not roles:
            raise DeepSpeedConfigError(
                f"fleet.{C.FLEET_ROLES} must be a non-empty dict of "
                f"role -> replica count (or omitted for a homogeneous "
                f"fleet), got {roles!r}")
        allowed = {"prefill", "decode", "mixed"}
        unknown = set(roles) - allowed
        if unknown:
            raise DeepSpeedConfigError(
                f"fleet.{C.FLEET_ROLES} has unknown role(s) "
                f"{sorted(unknown)}; allowed: {sorted(allowed)}")
        for role, count in roles.items():
            if not isinstance(count, int) or isinstance(count, bool) \
                    or count < 1:
                raise DeepSpeedConfigError(
                    f"fleet.{C.FLEET_ROLES}.{role} must be an int >= 1 "
                    f"replica, got {count!r}")
        # a prefill-only replica can never decode, so its migrations
        # need somewhere to land (mixed replicas can adopt too)
        if "prefill" in roles and not ({"decode", "mixed"} & set(roles)):
            raise DeepSpeedConfigError(
                f"fleet.{C.FLEET_ROLES}={dict(roles)} has prefill "
                "replicas but nowhere to migrate finished prefills: "
                "add a 'decode' (or 'mixed') role")
        return dict(roles)


class DeepSpeedPipelineConfig:
    def __init__(self, param_dict: Dict[str, Any]):
        pipe = param_dict.get(C.PIPELINE) or {}
        self.stages = get_scalar_param(
            pipe, C.PIPELINE_STAGES, C.PIPELINE_STAGES_DEFAULT)
        self.partition = get_scalar_param(
            pipe, C.PIPELINE_PARTITION, C.PIPELINE_PARTITION_DEFAULT)
        self.seed_layers = get_scalar_param(
            pipe, C.PIPELINE_SEED_LAYERS, C.PIPELINE_SEED_LAYERS_DEFAULT)
        self.activation_checkpoint_interval = get_scalar_param(
            pipe, C.PIPELINE_ACTIVATION_CHECKPOINT_INTERVAL,
            C.PIPELINE_ACTIVATION_CHECKPOINT_INTERVAL_DEFAULT)
        self.schedule = get_scalar_param(
            pipe, C.PIPELINE_SCHEDULE, C.PIPELINE_SCHEDULE_DEFAULT)


class DeepSpeedConfigWriter:
    """Build/modify ds_config json files from templates
    (reference: runtime/config.py:468-482 — used by launch scripts to
    tweak parameters from the command line)."""

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        self.data = data if data is not None else {}

    def add_config(self, key: str, value: Any) -> None:
        self.data[key] = value

    def load_config(self, filename: str) -> None:
        with open(filename) as f:
            self.data = json.load(
                f, object_pairs_hook=_dict_raise_error_on_duplicate_keys)

    def write_config(self, filename: str) -> None:
        with open(filename, "w") as outfile:
            json.dump(self.data, outfile)


class DeepSpeedConfig:
    """Parse a ds_config path or dict; solve + validate the batch triangle.

    ``world_size`` is the number of data-parallel replicas (mesh ``data``-axis
    size on TPU — the analogue of the reference's DP world size).
    """

    def __init__(self, config: Any, world_size: int = 1):
        if isinstance(config, (str,)):
            with open(config, "r") as f:
                self._param_dict = json.load(
                    f, object_pairs_hook=_dict_raise_error_on_duplicate_keys)
        elif isinstance(config, dict):
            self._param_dict = config
        else:
            raise DeepSpeedConfigError(
                f"Expected a config path or dict, got {type(config)}")

        self.world_size = world_size
        pd = self._param_dict

        self.train_batch_size = pd.get(C.TRAIN_BATCH_SIZE, C.TRAIN_BATCH_SIZE_DEFAULT)
        self.train_micro_batch_size_per_gpu = pd.get(
            C.TRAIN_MICRO_BATCH_SIZE_PER_GPU, C.TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT)
        self.gradient_accumulation_steps = pd.get(
            C.GRADIENT_ACCUMULATION_STEPS, C.GRADIENT_ACCUMULATION_STEPS_DEFAULT)
        self.steps_per_print = pd.get(C.STEPS_PER_PRINT, C.STEPS_PER_PRINT_DEFAULT)
        self.dump_state = pd.get(C.DUMP_STATE, C.DUMP_STATE_DEFAULT)
        self.wall_clock_breakdown = pd.get(
            C.WALL_CLOCK_BREAKDOWN, C.WALL_CLOCK_BREAKDOWN_DEFAULT)
        self.memory_breakdown = pd.get(C.MEMORY_BREAKDOWN, C.MEMORY_BREAKDOWN_DEFAULT)

        self.gradient_clipping = pd.get(C.GRADIENT_CLIPPING, C.GRADIENT_CLIPPING_DEFAULT)
        self.prescale_gradients = pd.get(
            C.PRESCALE_GRADIENTS, C.PRESCALE_GRADIENTS_DEFAULT)
        self.gradient_predivide_factor = pd.get(
            C.GRADIENT_PREDIVIDE_FACTOR, C.GRADIENT_PREDIVIDE_FACTOR_DEFAULT)
        self.sparse_gradients_enabled = pd.get(
            C.SPARSE_GRADIENTS, C.SPARSE_GRADIENTS_DEFAULT)
        self.allreduce_always_fp32 = pd.get(
            C.ALLREDUCE_ALWAYS_FP32, C.ALLREDUCE_ALWAYS_FP32_DEFAULT)
        self.disable_allgather = pd.get(
            C.DISABLE_ALLGATHER, C.DISABLE_ALLGATHER_DEFAULT)

        opt = pd.get(C.OPTIMIZER)
        self.optimizer_name = opt.get(C.TYPE) if opt else None
        if self.optimizer_name is not None:
            self.optimizer_name = self.optimizer_name.lower()
        self.optimizer_params = (opt.get(C.OPTIMIZER_PARAMS) if opt else None) or {}
        self.optimizer_legacy_fusion = (
            opt.get(C.LEGACY_FUSION, C.LEGACY_FUSION_DEFAULT) if opt else False)

        sched = pd.get(C.SCHEDULER)
        self.scheduler_name = sched.get(C.TYPE) if sched else None
        self.scheduler_params = (sched.get(C.SCHEDULER_PARAMS) if sched else None) or {}

        self.fp16 = DeepSpeedFP16Config(pd)
        self.bf16 = DeepSpeedBF16Config(pd)
        # Apex AMP block (reference constants.py:162-172): no apex on TPU —
        # enabled => native bf16 mixed precision, the closest equivalent
        amp = pd.get(C.AMP) or {}
        self.amp_enabled = bool(amp.get(C.AMP_ENABLED, C.AMP_ENABLED_DEFAULT))
        self.amp_params = {k: v for k, v in amp.items()
                           if k != C.AMP_ENABLED}
        if self.amp_enabled:
            if self.fp16.enabled:
                raise DeepSpeedConfigError(
                    "amp and fp16 are mutually exclusive (reference "
                    "config sanity: engine chooses ONE precision scheme)")
            if not self.bf16.enabled:
                logger.warning(
                    "amp has no apex on TPU; mapping to native bf16 "
                    "mixed precision (amp_params recorded, not applied)")
                self.bf16.enabled = True
        self.zero_allow_untested_optimizer = pd.get(
            C.ZERO_ALLOW_UNTESTED_OPTIMIZER,
            C.ZERO_ALLOW_UNTESTED_OPTIMIZER_DEFAULT)
        self.zero_config = DeepSpeedZeroConfig(pd)
        self.activation_checkpointing_config = (
            DeepSpeedActivationCheckpointingConfig(pd))
        self.sparse_attention_config = DeepSpeedSparseAttentionConfig(pd)
        self.pld_config = DeepSpeedPLDConfig(pd)
        self.tensorboard_config = DeepSpeedTensorboardConfig(pd)
        self.profiler_config = DeepSpeedProfilerConfig(pd)
        self.telemetry_config = DeepSpeedTelemetryConfig(pd)
        self.data_prefetch_config = DeepSpeedDataPrefetchConfig(pd)
        self.checkpoint_config = DeepSpeedCheckpointConfig(pd)
        self.stages_config = DeepSpeedStagesConfig(pd)
        self.offload_config = DeepSpeedOffloadConfig(pd)
        self.serving_config = DeepSpeedServingConfig(pd)
        self.fleet_config = DeepSpeedFleetConfig(pd)
        self.pipeline_config = DeepSpeedPipelineConfig(pd)

        self._solve_batch_triangle()
        self._do_sanity_check()

    # ---- compat properties matching reference attribute names ----
    @property
    def fp16_enabled(self):
        return self.fp16.enabled

    @property
    def bf16_enabled(self):
        return self.bf16.enabled

    @property
    def loss_scale(self):
        return self.fp16.loss_scale

    @property
    def zero_enabled(self):
        return self.zero_config.stage > 0

    @property
    def zero_optimization_stage(self):
        return self.zero_config.stage

    def _solve_batch_triangle(self):
        """Solve train_batch = micro_batch * grad_acc * world_size given any
        subset (reference: runtime/config.py:586-636)."""
        train = self.train_batch_size
        micro = self.train_micro_batch_size_per_gpu
        accum = self.gradient_accumulation_steps
        ws = self.world_size

        if train is not None and micro is not None and accum is not None:
            pass  # fully specified; checked below
        elif train is not None and micro is not None:
            accum = train // (micro * ws)
        elif train is not None and accum is not None:
            micro = train // (ws * accum)
        elif micro is not None and accum is not None:
            train = micro * accum * ws
        elif train is not None:
            accum = 1
            micro = train // ws
        elif micro is not None:
            train = micro * ws
            accum = 1
        else:
            raise DeepSpeedConfigError(
                "At least one of train_batch_size or "
                "train_micro_batch_size_per_gpu must be set")

        self.train_batch_size = train
        self.train_micro_batch_size_per_gpu = micro
        self.gradient_accumulation_steps = accum

        if train != micro * accum * ws:
            raise DeepSpeedConfigError(
                f"Batch triangle check failed: train_batch_size={train} != "
                f"micro_batch={micro} * grad_acc={accum} * world_size={ws}")
        for name, v in [("train_batch_size", train),
                        ("train_micro_batch_size_per_gpu", micro),
                        ("gradient_accumulation_steps", accum)]:
            if not isinstance(v, int) or v <= 0:
                raise DeepSpeedConfigError(f"{name} must be a positive int, got {v!r}")

    def _do_sanity_check(self):
        if self.zero_enabled and not (self.fp16_enabled or self.bf16_enabled):
            # The reference requires fp16 for ZeRO (config.py:664 there); on
            # TPU we additionally accept bf16 (the native dtype).
            raise DeepSpeedConfigError(
                "ZeRO optimization requires fp16 or bf16 to be enabled")
        if self.zero_config.cpu_offload and self.zero_config.stage < 2:
            raise DeepSpeedConfigError(
                "cpu_offload requires ZeRO stage >= 2")
        if self.zero_config.offload_grad_chunks > 1:
            if not self.zero_config.cpu_offload:
                raise DeepSpeedConfigError(
                    "offload_grad_chunks > 1 requires cpu_offload")
            if self.zero_config.offload_impl == "host":
                raise DeepSpeedConfigError(
                    "offload_grad_chunks > 1 is an xla-tier capacity mode "
                    "(offload_impl 'xla' or 'auto')")
        if self.zero_config.offload_split_update:
            if not self.zero_config.cpu_offload:
                raise DeepSpeedConfigError(
                    "offload_split_update requires cpu_offload")
            if self.zero_config.offload_impl == "host":
                raise DeepSpeedConfigError(
                    "offload_split_update is an xla-tier mode "
                    "(offload_impl 'xla' or 'auto')")
        if self.zero_config.delayed_param_update:
            if not self.zero_config.cpu_offload:
                raise DeepSpeedConfigError(
                    "delayed_param_update requires cpu_offload")
        if (self.zero_config.offload_pipeline_explicit
                and self.zero_config.offload_pipeline
                and not self.zero_config.cpu_offload):
            raise DeepSpeedConfigError(
                "offload_pipeline requires cpu_offload (it streams the "
                "host-tier optimizer update)")
        if self.zero_config.param_streaming:
            if not self.zero_config.cpu_offload:
                raise DeepSpeedConfigError(
                    "param_streaming requires cpu_offload")
            if self.zero_config.offload_impl == "host":
                raise DeepSpeedConfigError(
                    "param_streaming is an xla-tier capacity mode "
                    "(offload_impl 'xla' or 'auto')")
        if self.offload_config.tier == "disk":
            if not self.zero_config.cpu_offload:
                raise DeepSpeedConfigError(
                    "offload.tier='disk' requires "
                    "zero_optimization.cpu_offload (the disk tier sits "
                    "below the host offload plane)")
            if self.zero_config.offload_impl == "xla":
                raise DeepSpeedConfigError(
                    "offload.tier='disk' is a host-impl structure "
                    "(per-leaf C++ Adam over disk-resident state); "
                    "offload_impl must be 'host' or 'auto'")
        if self.optimizer_name is not None and self.optimizer_name in (
                C.ONEBIT_ADAM_OPTIMIZER,) and not (self.fp16_enabled or self.bf16_enabled):
            raise DeepSpeedConfigError("onebitadam requires fp16 or bf16")

    def print_config(self):
        logger.info("DeepSpeedConfig:")
        for k in ("train_batch_size", "train_micro_batch_size_per_gpu",
                  "gradient_accumulation_steps", "world_size", "optimizer_name",
                  "scheduler_name", "gradient_clipping"):
            logger.info("  %s: %s", k, getattr(self, k))
        logger.info("  zero: %s", self.zero_config.repr_dict())
