"""Canonical ds_config.json key names and defaults.

Key-for-key compatible with the reference config surface
(reference: deepspeed/runtime/constants.py, deepspeed/runtime/zero/constants.py)
so existing ``ds_config.json`` files parse unchanged.  Defaults differ only
where TPU hardware makes the reference default meaningless (noted inline).
"""

#############################################
# Batch-size triangle
#############################################
TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_BATCH_SIZE_DEFAULT = None

TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT = None

GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"
GRADIENT_ACCUMULATION_STEPS_DEFAULT = None

#############################################
# Optimizer / scheduler blocks
#############################################
OPTIMIZER = "optimizer"
OPTIMIZER_PARAMS = "params"
TYPE = "type"
LEGACY_FUSION = "legacy_fusion"
LEGACY_FUSION_DEFAULT = False

SCHEDULER = "scheduler"
SCHEDULER_PARAMS = "params"

ADAM_OPTIMIZER = "adam"
LAMB_OPTIMIZER = "lamb"
ONEBIT_ADAM_OPTIMIZER = "onebitadam"
DEEPSPEED_OPTIMIZERS = [ADAM_OPTIMIZER, LAMB_OPTIMIZER, ONEBIT_ADAM_OPTIMIZER]

#############################################
# Precision (fp16 block kept for config parity; bf16 is the TPU default)
#############################################
FP16 = "fp16"
FP16_ENABLED = "enabled"
FP16_ENABLED_DEFAULT = False
FP16_LOSS_SCALE = "loss_scale"
FP16_LOSS_SCALE_DEFAULT = 0
FP16_INITIAL_SCALE_POWER = "initial_scale_power"
FP16_INITIAL_SCALE_POWER_DEFAULT = 32
FP16_LOSS_SCALE_WINDOW = "loss_scale_window"
FP16_LOSS_SCALE_WINDOW_DEFAULT = 1000
FP16_HYSTERESIS = "hysteresis"
FP16_HYSTERESIS_DEFAULT = 2
FP16_MIN_LOSS_SCALE = "min_loss_scale"
FP16_MIN_LOSS_SCALE_DEFAULT = 1

# TPU-native extension: bf16 needs no loss scaling.
BF16 = "bf16"
BF16_ENABLED = "enabled"
BF16_ENABLED_DEFAULT = False

#############################################
# Gradient handling
#############################################
GRADIENT_CLIPPING = "gradient_clipping"
GRADIENT_CLIPPING_DEFAULT = 0.0

# Apex AMP block (reference constants.py:162-172).  Apex has no TPU
# analogue; the block is accepted for ds_config compatibility and, when
# enabled, maps to native bf16 mixed precision (the closest equivalent).
AMP = "amp"
AMP_ENABLED = "enabled"
AMP_ENABLED_DEFAULT = False

# reference constants.py:73 — client optimizers outside the ZeRO whitelist.
# Under GSPMD any optax transformation's state shards generically, so the
# key is accepted and recorded (nothing to gate).
ZERO_ALLOW_UNTESTED_OPTIMIZER = "zero_allow_untested_optimizer"
ZERO_ALLOW_UNTESTED_OPTIMIZER_DEFAULT = False

PRESCALE_GRADIENTS = "prescale_gradients"
PRESCALE_GRADIENTS_DEFAULT = False

GRADIENT_PREDIVIDE_FACTOR = "gradient_predivide_factor"
GRADIENT_PREDIVIDE_FACTOR_DEFAULT = 1.0

SPARSE_GRADIENTS = "sparse_gradients"
SPARSE_GRADIENTS_DEFAULT = False

ALLREDUCE_ALWAYS_FP32 = "fp32_allreduce"
ALLREDUCE_ALWAYS_FP32_DEFAULT = False

DISABLE_ALLGATHER = "disable_allgather"
DISABLE_ALLGATHER_DEFAULT = False

#############################################
# ZeRO
#############################################
ZERO_OPTIMIZATION = "zero_optimization"
ZERO_OPTIMIZATION_DISABLED = 0
ZERO_OPTIMIZATION_OPTIMIZER_STATES = 1
ZERO_OPTIMIZATION_GRADIENTS = 2
ZERO_OPTIMIZATION_WEIGHTS = 3
# Unlike the reference (capped at stage 2: zero/constants.py:33), the TPU
# build supports parameter sharding (stage 3) natively via GSPMD.
MAX_STAGE_ZERO_OPTIMIZATION = ZERO_OPTIMIZATION_WEIGHTS

ZERO_STAGE = "stage"
ZERO_STAGE_DEFAULT = ZERO_OPTIMIZATION_DISABLED

ZERO_ALLGATHER_PARTITIONS = "allgather_partitions"
ZERO_ALLGATHER_PARTITIONS_DEFAULT = True
ZERO_REDUCE_SCATTER = "reduce_scatter"
ZERO_REDUCE_SCATTER_DEFAULT = True
ZERO_OVERLAP_COMM = "overlap_comm"
ZERO_OVERLAP_COMM_DEFAULT = False
ZERO_CONTIGUOUS_GRADIENTS = "contiguous_gradients"
ZERO_CONTIGUOUS_GRADIENTS_DEFAULT = False
ZERO_REDUCE_BUCKET_SIZE = "reduce_bucket_size"
ZERO_REDUCE_BUCKET_SIZE_DEFAULT = 500_000_000
ZERO_ALLGATHER_BUCKET_SIZE = "allgather_bucket_size"
ZERO_ALLGATHER_BUCKET_SIZE_DEFAULT = 500_000_000
ZERO_CPU_OFFLOAD = "cpu_offload"
ZERO_CPU_OFFLOAD_DEFAULT = False
# TPU extension: which offload tier implements cpu_offload.
#   'xla'  — optimizer state in pinned_host memory; cast + Adam run as XLA
#            host computations inside the one compiled step (server-side
#            PCIe streaming, XLA-scheduled overlap).
#   'host' — single-controller numpy tier + native C++ CPU Adam.
#   'auto' — 'xla' on TPU meshes, 'host' elsewhere.
ZERO_OFFLOAD_IMPL = "offload_impl"
ZERO_OFFLOAD_IMPL_DEFAULT = "auto"
# TPU extension (capacity mode): compute parameter gradients in K
# balanced groups, one compiled program per group, so device-resident
# gradient bytes are bounded by the largest group instead of the full
# model (the program boundary guarantees the liveness bound).  Each
# group re-runs the forward — a deliberate K× compute trade for
# capacity, the in-XLA analogue of the reference streaming grads into
# pinned host buffers during backward (stage2.py:743-816).  1 = off.
ZERO_OFFLOAD_GRAD_CHUNKS = "offload_grad_chunks"
ZERO_OFFLOAD_GRAD_CHUNKS_DEFAULT = 1
# TPU extension (host tier): delayed parameter update — the host Adam
# for step t runs concurrently with the device forward/backward of step
# t+1, which therefore uses one-step-stale parameters (the ZeRO-Offload
# paper's DPU; the reference repo gained it after v0.3.2).  Off by
# default: staleness changes numerics slightly, so it is opt-in like
# the paper describes (enable after convergence stabilizes).
ZERO_DELAYED_PARAM_UPDATE = "delayed_param_update"
ZERO_DELAYED_PARAM_UPDATE_DEFAULT = False
# TPU extension (capacity mode, xla tier): ZeRO-Infinity-style parameter
# streaming (reference: deepspeed/runtime/zero/partition_parameters.py +
# the ZeRO-Infinity paper's NVMe/CPU param offload).  Compute copies of
# the leaves the model marks via ``TrainModule.streaming_param_spec``
# (its stacked-over-layers scan leaves) STAY in host memory; the model
# fetches one layer's slice per scan tick, so device-resident parameter
# bytes ~ one layer instead of 2 bytes/param for the whole model — the
# floor that bounds offload_grad_chunks capacity.  Composes with dp=1
# (any ZeRO stage >= 2) or ZeRO-3 (host leaves stay data-sharded; no
# host-side collectives are ever needed).
ZERO_PARAM_STREAMING = "param_streaming"
ZERO_PARAM_STREAMING_DEFAULT = False
# TPU extension (xla tier): run the optimizer update as ONE COMPILED
# PROGRAM PER MASTER PIECE instead of one fused update program.  XLA
# cannot extend buffer liveness across program boundaries, so device-
# resident optimizer-state bytes are bounded by the largest piece even
# where the compiler materializes host-placed buffers in HBM (observed
# on the AOT compile path: the fused 1.5B update program allocated the
# whole fp32 state as HBM temps).  Costs one dispatch per piece per
# step; numerics identical.  Composes with delayed_param_update: the
# deferred per-piece programs run without donation (ping-pong, the same
# transient 2x host state the fused DPU pays) so the next step's grad
# program can keep reading the old pieces.
ZERO_OFFLOAD_SPLIT_UPDATE = "offload_split_update"
ZERO_OFFLOAD_SPLIT_UPDATE_DEFAULT = False
# TPU extension (host tier): streaming offload update pipeline — the
# engine uploads each leaf's updated low-precision copy H2D the moment
# the C++ Adam writes its block, so while Adam updates leaf i, leaf
# i+1's gradient D2H is in flight AND leaf i-1's upload is already
# streaming (the full three-stage overlap of the ZeRO-Offload design;
# the serial path only overlapped the D2H half).  Numerics identical to
# the serial path.  Default ON; set false (or DS_OFFLOAD_PIPELINE=0,
# the no-config escape hatch) to restore the serial post-step upload.
ZERO_OFFLOAD_PIPELINE = "offload_pipeline"
ZERO_OFFLOAD_PIPELINE_DEFAULT = True
ZERO_ELASTIC_CHECKPOINT = "elastic_checkpoint"
ZERO_ELASTIC_CHECKPOINT_DEFAULT = True
ZERO_MAX_ELEMENTS_PER_COMM = "max_elements_per_comm"
ZERO_MAX_ELEMENTS_PER_COMM_DEFAULT = 500_000_000
# Partitioning-correctness debug toggle (the reference's module-level
# ``pg_correctness_test`` in stage2.py:23-25 — here a config key): the
# engine diffs plan-sharded gradients against an unconstrained replicated
# reduction on the first step and raises on mismatch.
ZERO_PG_CORRECTNESS_TEST = "pg_correctness_test"
ZERO_PG_CORRECTNESS_TEST_DEFAULT = False

#############################################
# Activation checkpointing (rematerialization on TPU)
#############################################
ACTIVATION_CHECKPOINTING = "activation_checkpointing"
ACT_CKPT_PARTITION_ACTIVATIONS = "partition_activations"
ACT_CKPT_PARTITION_ACTIVATIONS_DEFAULT = False
ACT_CKPT_NUMBER_CHECKPOINTS = "number_checkpoints"
ACT_CKPT_NUMBER_CHECKPOINTS_DEFAULT = None
ACT_CKPT_CONTIGUOUS_MEMORY_OPTIMIZATION = "contiguous_memory_optimization"
ACT_CKPT_CONTIGUOUS_MEMORY_OPTIMIZATION_DEFAULT = False
ACT_CKPT_SYNCHRONIZE_CHECKPOINT_BOUNDARY = "synchronize_checkpoint_boundary"
ACT_CKPT_SYNCHRONIZE_CHECKPOINT_BOUNDARY_DEFAULT = False
ACT_CKPT_PROFILE = "profile"
ACT_CKPT_PROFILE_DEFAULT = False
ACT_CKPT_CPU_CHECKPOINTING = "cpu_checkpointing"
ACT_CKPT_CPU_CHECKPOINTING_DEFAULT = False

#############################################
# Sparse attention
#############################################
SPARSE_ATTENTION = "sparse_attention"
SPARSE_MODE = "mode"
SPARSE_MODE_DEFAULT = "fixed"
SPARSE_DENSE_MODE = "dense"
SPARSE_FIXED_MODE = "fixed"
SPARSE_VARIABLE_MODE = "variable"
SPARSE_BIGBIRD_MODE = "bigbird"
SPARSE_BSLONGFORMER_MODE = "bslongformer"
SPARSE_BLOCK = "block"
SPARSE_BLOCK_DEFAULT = 16
SPARSE_DIFFERENT_LAYOUT_PER_HEAD = "different_layout_per_head"
SPARSE_DIFFERENT_LAYOUT_PER_HEAD_DEFAULT = False
SPARSE_NUM_LOCAL_BLOCKS = "num_local_blocks"
SPARSE_NUM_LOCAL_BLOCKS_DEFAULT = 4
SPARSE_NUM_GLOBAL_BLOCKS = "num_global_blocks"
SPARSE_NUM_GLOBAL_BLOCKS_DEFAULT = 1
SPARSE_ATTENTION_TYPE = "attention"
SPARSE_ATTENTION_TYPE_DEFAULT = "bidirectional"
SPARSE_HORIZONTAL_GLOBAL_ATTENTION = "horizontal_global_attention"
SPARSE_HORIZONTAL_GLOBAL_ATTENTION_DEFAULT = False
SPARSE_NUM_DIFFERENT_GLOBAL_PATTERNS = "num_different_global_patterns"
SPARSE_NUM_DIFFERENT_GLOBAL_PATTERNS_DEFAULT = 1
SPARSE_NUM_RANDOM_BLOCKS = "num_random_blocks"
SPARSE_NUM_RANDOM_BLOCKS_DEFAULT = 0
SPARSE_LOCAL_WINDOW_BLOCKS = "local_window_blocks"
SPARSE_LOCAL_WINDOW_BLOCKS_DEFAULT = [4]
SPARSE_GLOBAL_BLOCK_INDICES = "global_block_indices"
SPARSE_GLOBAL_BLOCK_INDICES_DEFAULT = [0]
SPARSE_GLOBAL_BLOCK_END_INDICES = "global_block_end_indices"
SPARSE_GLOBAL_BLOCK_END_INDICES_DEFAULT = None
SPARSE_NUM_SLIDING_WINDOW_BLOCKS = "num_sliding_window_blocks"
SPARSE_NUM_SLIDING_WINDOW_BLOCKS_DEFAULT = 3

#############################################
# Pipeline block (TPU extension mirrors reference engine kwargs)
#############################################
PIPELINE = "pipeline"
PIPELINE_STAGES = "stages"
PIPELINE_STAGES_DEFAULT = 1
PIPELINE_PARTITION = "partition"
PIPELINE_PARTITION_DEFAULT = "best"
PIPELINE_SEED_LAYERS = "seed_layers"
PIPELINE_SEED_LAYERS_DEFAULT = False
PIPELINE_ACTIVATION_CHECKPOINT_INTERVAL = "activation_checkpoint_interval"
PIPELINE_ACTIVATION_CHECKPOINT_INTERVAL_DEFAULT = 0
# compiled schedule: "1f1b" (hand-scheduled backward, min(S,M) activation
# ring — the reference TrainSchedule's memory bound), "1f1b_uniform"
# (F+B units masked every tick: schedule-invariant collectives — the
# variant that carries sequence parallelism; min(2S-1,M) ring; selected
# automatically for "1f1b" when the mesh has seq > 1), or "gpipe" (AD
# over the fill/drain scan; O(M) boundary liveness, kept as the fallback)
PIPELINE_SCHEDULE = "schedule"
PIPELINE_SCHEDULE_DEFAULT = "1f1b"

#############################################
# Logging / observability
#############################################
STEPS_PER_PRINT = "steps_per_print"
STEPS_PER_PRINT_DEFAULT = 10

WALL_CLOCK_BREAKDOWN = "wall_clock_breakdown"
WALL_CLOCK_BREAKDOWN_DEFAULT = False

MEMORY_BREAKDOWN = "memory_breakdown"
MEMORY_BREAKDOWN_DEFAULT = False

DUMP_STATE = "dump_state"
DUMP_STATE_DEFAULT = False

# XLA/xplane trace capture (TPU-native upgrade of the reference's
# cuda-synchronized named timers, utils/timer.py there; SURVEY §5.1 notes
# the reference ships no external tracer — on TPU the jax.profiler xplane
# trace is the native equivalent, viewable in tensorboard-profile/xprof).
PROFILER = "profiler"
PROFILER_ENABLED = "enabled"
PROFILER_ENABLED_DEFAULT = False
PROFILER_START_STEP = "start_step"
PROFILER_START_STEP_DEFAULT = 2       # skip compile on step 0/1
PROFILER_NUM_STEPS = "num_steps"
PROFILER_NUM_STEPS_DEFAULT = 3
PROFILER_OUTPUT_PATH = "output_path"
PROFILER_OUTPUT_PATH_DEFAULT = "/tmp/deepspeed_tpu_profile"

TENSORBOARD = "tensorboard"
TENSORBOARD_ENABLED = "enabled"
TENSORBOARD_ENABLED_DEFAULT = False
TENSORBOARD_OUTPUT_PATH = "output_path"
TENSORBOARD_OUTPUT_PATH_DEFAULT = ""
TENSORBOARD_JOB_NAME = "job_name"
TENSORBOARD_JOB_NAME_DEFAULT = "DeepSpeedJobName"

# Unified telemetry block (TPU extension; docs/observability.md): one
# structured observability layer — metrics registry with JSONL /
# Prometheus / SummaryWriter exporters, Chrome-trace span tracing that
# rides the engine's EXISTING sync points (zero added per-step device
# syncs, unlike wall_clock_breakdown), jax.monitoring compile tracking
# (recompiles_total{program=...} — jaxlint JL005's runtime complement),
# and device-memory gauges from the structured memory_status.
TELEMETRY = "telemetry"
TELEMETRY_ENABLED = "enabled"
TELEMETRY_ENABLED_DEFAULT = False
# "" resolves to <cwd>/telemetry; files: events.jsonl, trace.json,
# metrics.prom
TELEMETRY_OUTPUT_PATH = "output_path"
TELEMETRY_OUTPUT_PATH_DEFAULT = ""
TELEMETRY_TRACE = "trace"
TELEMETRY_TRACE_DEFAULT = True
TELEMETRY_COMPILE_EVENTS = "compile_events"
TELEMETRY_COMPILE_EVENTS_DEFAULT = True
TELEMETRY_MEMORY = "memory"
TELEMETRY_MEMORY_DEFAULT = True
# retraces of one program within a single sample window that trigger the
# recompile-storm warning
TELEMETRY_STORM_THRESHOLD = "recompile_storm_threshold"
TELEMETRY_STORM_THRESHOLD_DEFAULT = 3
# Elastic-training liveness (docs/elastic.md): every process writes a
# per-host heartbeat file each step (atomic JSON) into a shared dir —
# the supervisor's liveness signal and the straggler monitor's input.
# Enabled implicitly when the supervisor exports DS_HEARTBEAT_DIR;
# `heartbeat: true` enables it without a supervisor (files land under
# heartbeat_dir, default <telemetry output>/heartbeats).
TELEMETRY_HEARTBEAT = "heartbeat"
TELEMETRY_HEARTBEAT_DEFAULT = False
TELEMETRY_HEARTBEAT_DIR = "heartbeat_dir"
TELEMETRY_HEARTBEAT_DIR_DEFAULT = ""
# a host whose per-step time exceeds this multiple of the fleet median
# is flagged (straggler_detected_total + summarize row); must be > 1
TELEMETRY_STRAGGLER_RATIO = "straggler_ratio"
TELEMETRY_STRAGGLER_RATIO_DEFAULT = 2.0
# One-shot anomaly trigger (docs/observability.md): when a synced
# interval's per-step time exceeds anomaly_ratio x the trailing median
# of recent intervals — or the straggler monitor flags THIS host — the
# engine fires ONE bounded jax.profiler capture (stopped at the next
# sync) plus a flight-record dump, so the slow episode is captured
# while it is still happening.  Opt-in: 0.0 (default) disables; when
# set it must be > 1.0 (it multiplies the trailing median).
TELEMETRY_ANOMALY_RATIO = "anomaly_ratio"
TELEMETRY_ANOMALY_RATIO_DEFAULT = 0.0

# Asynchronous input pipeline (TPU extension; docs/observability.md):
# a single daemon worker prefetches batches through a bounded queue and
# runs collate + batch sharding (H2D placement) OFF the step loop's
# thread, so train_batch receives already-device-resident pytrees — the
# input-feeding half of the ZeRO-Offload overlap story.  Default ON;
# set enabled:false (or DS_PREFETCH=0, the no-config escape hatch) to
# restore the inline collate+placement.  ``depth`` is the queue bound
# (2 = double buffering: one batch consumed, one staged ahead).
DATA_PREFETCH = "data_prefetch"
DATA_PREFETCH_ENABLED = "enabled"
DATA_PREFETCH_ENABLED_DEFAULT = True
DATA_PREFETCH_DEPTH = "depth"
DATA_PREFETCH_DEPTH_DEFAULT = 2

#############################################
# Fault-tolerant checkpointing (TPU extension; docs/checkpointing.md)
#############################################
# One block for the save/load resilience plane: async background writes,
# integrity verification (per-leaf CRC32 + manifest digests), the
# corrupt-latest fallback chain, retention GC, transient-I/O retry, and
# the SIGTERM preemption hook.  The reference writes synchronously and
# trusts the filesystem (reference engine.py:1211-1290).
CHECKPOINT = "checkpoint"
# true = every save_checkpoint call defaults to the async path (snapshot
# to host, daemon writer serializes off the hot path); per-call
# async_write= overrides.  Single-controller only (multi-host saves need
# the cross-process barriers and stay synchronous).
CKPT_ASYNC_SAVE = "async_save"
CKPT_ASYNC_SAVE_DEFAULT = False
# retention: keep the newest N tags, GC older ones (and orphaned *.tmp
# dirs) strictly AFTER a new save verifies.  0 = unlimited (never
# delete) — the reference behavior, and the safe default.
CKPT_KEEP_LAST_N = "keep_last_n"
CKPT_KEEP_LAST_N_DEFAULT = 0
# corrupt-latest fallback: how many OLDER on-disk tags
# load_checkpoint(tag=None) tries (deep CRC verify) after the tag
# `latest` names fails verification or is gone.  0 disables walking back.
CKPT_LOAD_FALLBACK = "load_fallback"
CKPT_LOAD_FALLBACK_DEFAULT = 2
# transient-I/O retry: TOTAL attempts per read/write (1 = no retry) and
# the exponential-backoff base (full jitter; capped at 2s per wait)
CKPT_IO_RETRY_ATTEMPTS = "io_retry_attempts"
CKPT_IO_RETRY_ATTEMPTS_DEFAULT = 3
CKPT_IO_RETRY_BASE_S = "io_retry_base_s"
CKPT_IO_RETRY_BASE_S_DEFAULT = 0.05
# opt-in preemption hook: on SIGTERM, one final SYNCHRONOUS save + clean
# engine.close() so a preempted pod resumes at the last step instead of
# the last checkpoint-interval boundary.  Single-controller only.
CKPT_SIGTERM_SAVE = "sigterm_save"
CKPT_SIGTERM_SAVE_DEFAULT = False
# where the SIGTERM save lands when no save_checkpoint has run yet this
# process ("" = use the directory of the most recent save)
CKPT_SAVE_DIR = "save_dir"
CKPT_SAVE_DIR_DEFAULT = ""

#############################################
# Shared async-stage runtime (TPU extension; docs/stages.md)
#############################################
# One fault plane for every async subsystem (input prefetch, streamed
# offload uploads, the async checkpoint writer): shared worker/queue/
# poison/drain primitives in runtime/stages.py, a single documented
# drain order, and graceful degradation — a stage that keeps failing
# with a TRANSIENT error falls back to its inline/serial equivalent
# (prefetch -> inline iteration, streamed offload -> serial update,
# async save -> sync save) with one loud warning and a
# ``stage_degraded_total`` counter instead of killing the run.
STAGES = "stages"
# consecutive transient failures a stage absorbs (retrying) before it
# degrades.  1 = degrade on the first failure; the budget resets on
# every success.
STAGES_MAX_FAILURES = "max_stage_failures"
STAGES_MAX_FAILURES_DEFAULT = 3

#############################################
# Offload tier selection (ZeRO-Infinity disk tier; docs/stages.md)
#############################################
# Which tier holds the fp32 master params + Adam moments under
# cpu_offload with the host impl: "host" keeps them in host RAM (the
# PR 3 host tier), "disk" streams them through per-leaf CRC'd files in
# ``disk_dir`` (runtime/disk_offload.py) — host RAM then holds only a
# bounded window of leaves, so trainable size is capped by disk, not
# RAM.
OFFLOAD = "offload"
OFFLOAD_TIER = "tier"
OFFLOAD_TIER_DEFAULT = "host"
# directory for the disk tier's per-leaf state files (REQUIRED when
# tier == "disk"; created if missing).
OFFLOAD_DISK_DIR = "disk_dir"
OFFLOAD_DISK_DIR_DEFAULT = None
# bounded read-ahead/write-back depth of the disk pipeline: at most
# io_depth leaf states are prefetched from disk (and at most io_depth
# queued for write-back) while the C++ Adam runs — THE knob bounding
# resident host bytes to ~(2*io_depth + 1) leaf states.
OFFLOAD_IO_DEPTH = "io_depth"
OFFLOAD_IO_DEPTH_DEFAULT = 2
# per-file fsync before the atomic rename of each leaf-state write
# (power-loss durability; the DS_CKPT_FSYNC discipline).  The
# DS_DISK_FSYNC env var (default on; tests set 0) can force it off
# without a config edit — see runtime/disk_offload.py.
OFFLOAD_FSYNC = "fsync"
OFFLOAD_FSYNC_DEFAULT = True

#############################################
# Serving / inference engine (TPU extension; docs/serving.md)
#############################################
# The KV-cached decode engine with static-shape continuous batching
# (deepspeed_tpu/inference/).  The reference v0.3.2 ships no inference
# engine at all; this block configures the slot pool that one compiled
# decode program serves for arbitrary request mixes.
SERVING = "serving"
# fixed number of concurrent request slots — THE static batch shape of
# the decode program.  Admission/eviction are masked in-place KV
# updates, never a shape change.
SERVING_SLOTS = "slots"
SERVING_SLOTS_DEFAULT = 8
# per-slot KV capacity (prompt + generated tokens).  0 = the model's
# n_positions.
SERVING_MAX_SEQ_LEN = "max_seq_len"
SERVING_MAX_SEQ_LEN_DEFAULT = 0
# prompts are right-padded to this static bucket so prefill is ONE
# compiled program too.  0 = max_seq_len.
SERVING_PREFILL_LEN = "prefill_len"
SERVING_PREFILL_LEN_DEFAULT = 0
# decode attention kernel arm: 'pallas' (single-query flash kernel,
# interpret mode off-TPU), 'dense' (the jnp reference — the CPU
# fallback), or 'auto' (follow the model's attn_impl).
SERVING_DECODE_IMPL = "decode_impl"
SERVING_DECODE_IMPL_DEFAULT = "auto"
# bound of the request Channel feeding the slot scheduler; submit()
# blocks when full (open-loop backpressure).
SERVING_QUEUE_CAPACITY = "queue_capacity"
SERVING_QUEUE_CAPACITY_DEFAULT = 128
# serving ticks between telemetry materializations (tokens/s +
# per-token latency percentiles land as sync scalars each flush)
SERVING_FLUSH_INTERVAL = "flush_interval_ticks"
SERVING_FLUSH_INTERVAL_DEFAULT = 50
# default end-of-sequence token id finishing a request early; -1 = none
# (per-request eos_id overrides)
SERVING_EOS_ID = "eos_id"
SERVING_EOS_ID_DEFAULT = -1
# paged KV cache (PagedAttention, PAPERS.md): tokens-per-page of the
# flat page pool replacing the fixed max_seq_len stride per slot.
# 0 = paged OFF (the pre-page slot cache — the parity reference arm).
SERVING_PAGE_LEN = "page_len"
SERVING_PAGE_LEN_DEFAULT = 0
# total pages in the pool (page 0 is the reserved scratch page masked
# writes land on).  0 = auto: enough for every slot at max_seq_len
# (capacity-neutral) + the scratch page, rounded up to the mesh's data
# width so the pool DP-shards evenly.
SERVING_PAGES = "pages"
SERVING_PAGES_DEFAULT = 0
# prefix reuse over shared pages (RadixAttention, PAPERS.md): prompt
# prefixes hash to refcounted read-only pages so template-sharing
# requests pay prefill once; divergent appends copy-on-write the last
# partial page.  Only meaningful with page_len > 0.
SERVING_PREFIX_CACHE = "prefix_cache"
SERVING_PREFIX_CACHE_DEFAULT = True
# speculative decoding (Leviathan/Chen 2023, PAPERS.md): draft tokens
# proposed per tick; the target scores all k+1 positions in ONE widened
# verify program and emits the accepted prefix + one bonus token.
# 0 = speculation OFF (the one-token-per-tick parity reference arm).
SERVING_SPECULATE_K = "speculate_k"
SERVING_SPECULATE_K_DEFAULT = 0
# decode sampling temperature for the whole engine (STATIC — it picks
# the compiled emission/acceptance arm).  0.0 = greedy (bitwise the
# pre-sampling argmax); > 0 samples softmax(logits/T), and speculation
# switches to the Chen et al. rejection-sampling acceptance that
# recovers the target distribution exactly.
SERVING_TEMPERATURE = "temperature"
SERVING_TEMPERATURE_DEFAULT = 0.0
# the DRAFT model block (speculate_k > 0): a small GPT-2 config built
# through the ordinary config system.  vocab_size/n_positions are
# FORCED from the target model (the proposal streams must share a
# token space); everything else defaults tiny.  The draft always runs
# its own fixed-stride slot KV cache — at draft scale a full stride is
# a rounding error next to the target's pool, paged or not.
SERVING_DRAFT = "draft"
SERVING_DRAFT_D_MODEL = "d_model"
SERVING_DRAFT_D_MODEL_DEFAULT = 256
SERVING_DRAFT_N_LAYER = "n_layer"
SERVING_DRAFT_N_LAYER_DEFAULT = 2
SERVING_DRAFT_N_HEAD = "n_head"
SERVING_DRAFT_N_HEAD_DEFAULT = 4
# draft attention impl: '' = follow the target model's attn_impl
SERVING_DRAFT_ATTN_IMPL = "attn_impl"
SERVING_DRAFT_ATTN_IMPL_DEFAULT = ""
# quantized serving plane (LLM.int8 weights + KVQuant/KIVI-style KV
# pages, PAPERS.md; docs/serving.md "quantized serving").  Each arm is
# independently togglable; 'fp16' = the master dtype as loaded (fp16 on
# a half-precision deployment, fp32 on the CPU oracle) — NO cast, so
# the default config is bitwise-unchanged vs the pre-quant engine.
SERVING_QUANTIZATION = "quantization"
# 'int8': one-shot post-load symmetric per-output-channel absmax
# quantization of the GPT-2 matmul weights (attn qkv/proj, MLP) with
# dequant fused into the serving matmuls as (int8_w · x) * scale; the
# fp master copy never reaches device memory — params HBM ~ halved.
SERVING_QUANT_WEIGHTS = "weights"
SERVING_QUANT_WEIGHTS_DEFAULT = "fp16"
# 'int8': the paged KV pool stores int8 rows + a per-(page, head, row)
# fp32 scale sidecar, quantized on write inside the compiled programs
# and dequantized fused into the decode kernels — ~2x more pages in
# the same KV bytes, multiplicative with serving.page_len.  Requires
# page_len > 0 (the slot layout keeps the master dtype).
SERVING_QUANT_KV = "kv"
SERVING_QUANT_KV_DEFAULT = "fp16"
# chunked prefill (Sarathi-Serve, PAPERS.md; docs/serving.md
# "disaggregated fleet"): prompts whose delta is longer than this are
# prefilled one fixed-size chunk per engine step, co-scheduled with
# decode ticks, so a long admission never stalls in-flight decodes.
# prefix_len/delta_len are traced, so every chunk reuses the ONE
# compiled prefill program.  0 = chunking OFF (whole-delta prefill at
# admission).  Requires page_len > 0.
SERVING_PREFILL_CHUNK_LEN = "prefill_chunk_len"
SERVING_PREFILL_CHUNK_LEN_DEFAULT = 0
# multi-tenant LoRA serving (S-LoRA / Punica, PAPERS.md;
# docs/serving.md "multi-tenant serving"): per-tenant low-rank
# adapters batched HETEROGENEOUSLY over one base model — each
# decode/prefill/verify pass gathers per-slot adapter weights by a
# traced int32 adapter-table indirection (the page-table idiom applied
# to weights) and fuses y += (x·A)·B · (alpha/rank) next to the base
# matmul, so requests for different tenants ride the SAME compiled
# tick.  Adapters live in a refcounted host/HBM residency pool managed
# exactly like KV pages (inference/adapters.py).
SERVING_LORA = "lora"
# the shared low-rank dimension r of every adapter (STATIC — it is a
# compiled shape).  0 = lora OFF: no pool, no extra operands, programs
# bitwise-unchanged vs the pre-lora engine.
SERVING_LORA_RANK = "rank"
SERVING_LORA_RANK_DEFAULT = 0
# the LoRA scaling numerator: deltas apply as (alpha / rank) · BAx.
# Static — baked into the compiled programs at trace time.
SERVING_LORA_ALPHA = "alpha"
SERVING_LORA_ALPHA_DEFAULT = 16.0
# registry capacity: distinct tenant adapters the HOST tier holds
# (cheap numpy copies — the S-LoRA main-memory tier)
SERVING_LORA_MAX_ADAPTERS = "max_adapters"
SERVING_LORA_MAX_ADAPTERS_DEFAULT = 64
# HBM residency slots: adapters resident on device simultaneously.
# Slot 0 is the reserved all-zero adapter (requests without a tenant
# gather it — a masked no-op, like the KV scratch page), so the device
# pool allocates hbm_adapter_slots + 1 slots.  Cold tenants LRU-evict
# refcount-0 residents; when every slot is referenced, admission PARKS
# (the page-pool backpressure contract).
SERVING_LORA_HBM_SLOTS = "hbm_adapter_slots"
SERVING_LORA_HBM_SLOTS_DEFAULT = 8
# which base matmuls carry adapters, by block-param name: any subset
# of qkv_w / out_w (attention) and fc_w / proj_w (MLP).  The default
# adapts the attention projections — the S-LoRA/Punica headline
# targets; widening to the MLP pair scales cost, not mechanism.
SERVING_LORA_TARGETS = "targets"
SERVING_LORA_TARGETS_DEFAULT = ("qkv_w", "out_w")

#############################################
# KV tiering (TPU extension; docs/serving.md "KV tiering")
#############################################
# Park idle sessions' KV pages off HBM (inference/kv_tier.py): cold
# prefix-cache pages spill HBM -> host RAM -> disk and stream back on
# session resume as a prefix-cache hit.  Rides the paged serving plane
# (serving.page_len > 0 with the prefix cache on).
SERVING_KV_TIER = "kv_tier"
# a prefix-cache leaf idle for this many engine TICKS is parked:
# exported to the host tier, CRC-stamped, then evicted from the page
# pool.  0 = KV tiering off (the default: no tier, no extra host
# copies, engine behavior bitwise unchanged).
SERVING_KV_TIER_IDLE_PARK_TICKS = "idle_park_ticks"
SERVING_KV_TIER_IDLE_PARK_TICKS_DEFAULT = 0
# parked page payloads kept in host RAM; beyond this the OLDEST parked
# pages write back to the disk tier (or, with no disk_dir, are dropped
# — resume recomputes them from the prompt).  0 = write-through: every
# parked page goes straight to disk.
SERVING_KV_TIER_HOST_BUDGET_PAGES = "host_budget_pages"
SERVING_KV_TIER_HOST_BUDGET_PAGES_DEFAULT = 256
# directory of the disk tier's parked-page files (PR 15's magic/JSON-
# header/section-CRC format, tmp+rename).  "" = no disk tier: the host
# budget is the tier's total capacity.
SERVING_KV_TIER_DISK_DIR = "disk_dir"
SERVING_KV_TIER_DISK_DIR_DEFAULT = ""
# fsync parked-page files before rename (crash durability for the disk
# tier; DS_DISK_FSYNC=0 force-disables, same switch as the optimizer
# disk tier)
SERVING_KV_TIER_FSYNC = "fsync"
SERVING_KV_TIER_FSYNC_DEFAULT = True

#############################################
# Serving fleet (TPU extension; docs/serving.md "serving fleet")
#############################################
# Router + replicated ServeEngines + SLO autoscaling
# (deepspeed_tpu/inference/fleet.py): one jax-free front door spawns N
# replica subprocesses, balances admissions join-shortest-queue over
# the replicas' heartbeat gauges, fails queued-but-unstarted requests
# over on replica death, and scales the replica count against a
# queue-wait SLO.
FLEET = "fleet"
# replicas launched at start() — the fleet's initial width
FLEET_REPLICAS = "replicas"
FLEET_REPLICAS_DEFAULT = 1
# autoscale clamps: the router never retires below min_replicas and
# never spawns above max_replicas (a runaway SLO breach must not fork
# the host to death)
FLEET_MIN_REPLICAS = "min_replicas"
FLEET_MIN_REPLICAS_DEFAULT = 1
FLEET_MAX_REPLICAS = "max_replicas"
FLEET_MAX_REPLICAS_DEFAULT = 4
# the SLO target: queue-wait (router submit -> replica admission) p99
# the autoscaler defends
FLEET_SLO_P99_S = "slo_p99_s"
FLEET_SLO_P99_S_DEFAULT = 2.0
# hysteresis windows: a breach (p99 over the SLO, or any request
# waiting longer than it) must persist scale_up_window_s before a spawn;
# slack (p99 under SLO/2 — or no waiters at all — with an empty router
# queue) must persist scale_down_window_s before a retire.  Every scale
# event resets both clocks, so the fleet can never flap inside a window.
FLEET_SCALE_UP_WINDOW_S = "scale_up_window_s"
FLEET_SCALE_UP_WINDOW_S_DEFAULT = 10.0
FLEET_SCALE_DOWN_WINDOW_S = "scale_down_window_s"
FLEET_SCALE_DOWN_WINDOW_S_DEFAULT = 30.0
# a replica whose newest heartbeat is older than this is HUNG (wedged
# device call with the process still alive): killed + failed over like
# a dead one.  0 = heartbeat liveness off (process exits only).
FLEET_HEARTBEAT_TIMEOUT_S = "heartbeat_timeout_s"
FLEET_HEARTBEAT_TIMEOUT_S_DEFAULT = 60.0
# crash-loop give-up budget: consecutive replica failures WITHOUT any
# request completing in between before the router raises the typed
# FleetGiveUpError (progress resets the count — a fleet serving for
# days must not die on its max_restarts'th isolated blip)
FLEET_MAX_RESTARTS = "max_restarts"
FLEET_MAX_RESTARTS_DEFAULT = 3
# exponential backoff between replica respawns (the elastic
# supervisor's discipline, launcher/supervise.py)
FLEET_BACKOFF_BASE_S = "backoff_base_s"
FLEET_BACKOFF_BASE_S_DEFAULT = 1.0
FLEET_BACKOFF_MAX_S = "backoff_max_s"
FLEET_BACKOFF_MAX_S_DEFAULT = 30.0
# a spawned replica must say hello within this budget or the spawn
# counts as failed (jax import + model build + first compile all land
# inside it — size generously for real models)
FLEET_SPAWN_TIMEOUT_S = "spawn_timeout_s"
FLEET_SPAWN_TIMEOUT_S_DEFAULT = 120.0
# SIGTERM -> grace -> SIGKILL teardown window per replica
FLEET_TERM_GRACE_S = "term_grace_s"
FLEET_TERM_GRACE_S_DEFAULT = 5.0
# disaggregated prefill/decode roles (DistServe/Splitwise, PAPERS.md;
# docs/serving.md "disaggregated fleet"): a mapping of role name ->
# initial replica count, keys from {"prefill", "decode", "mixed"}.
# None (the default) = every replica is "mixed" — the homogeneous
# fleet, byte-identical to the pre-role router.  With prefill+decode
# roles set, the router steers admissions to prefill replicas and
# migrates finished prefills' KV pages to decode replicas over binary
# wire frames; fleet.replicas, when given alongside roles, must equal
# the sum of the role counts.
FLEET_ROLES = "roles"
FLEET_ROLES_DEFAULT = None
# per-phase SLOs the role-aware autoscaler defends SEPARATELY:
# slo_ttft_s bounds time-to-first-token (prefill-role capacity; 0 =
# fall back to slo_p99_s) and slo_tpot_s bounds time-per-output-token
# p99 read from the decode replicas' heartbeat gauges (0 = TPOT
# scaling off).  Homogeneous fleets ignore both and keep the
# queue-wait SLO above.
FLEET_SLO_TTFT_S = "slo_ttft_s"
FLEET_SLO_TTFT_S_DEFAULT = 0.0
FLEET_SLO_TPOT_S = "slo_tpot_s"
FLEET_SLO_TPOT_S_DEFAULT = 0.0

PROGRESSIVE_LAYER_DROP = "progressive_layer_drop"
PLD_ENABLED = "enabled"
PLD_ENABLED_DEFAULT = False
PLD_THETA = "theta"
PLD_THETA_DEFAULT = 1.0
PLD_GAMMA = "gamma"
PLD_GAMMA_DEFAULT = 0.001
