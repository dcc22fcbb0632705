"""ServeEngine — the KV-cached decode engine (docs/serving.md), ported to
PyTorch: the slot cache, the paged pool with prefix caching and chunked
prefill, speculative decoding on both layouts, temperature sampling,
multi-tenant LoRA adapters, quantized serving, the KV tier and the
serving telemetry plane.

Requests stream through a bounded queue into a FIXED pool of decode
slots, and two steps serve every mix:

  prefill      one request's prompt (right-padded to the static
               ``serving.prefill_len`` bucket) → its K/V rows written
               into the assigned slot (or its pages) + the first
               token.  Runs the flash-attention forward kernel on
               ``attn_impl="flash"``.
  decode tick  ONE masked tick for ALL slots at once: each active slot's
               last token in, its next token out, its K/V appended
               in place.  Free/finished slots ride along masked.  Runs the
               single-query decode kernel (slot cache) or the paged one.

Admission/eviction are the continuous-batching moves (Orca, PAPERS.md):
a finished slot is refilled on the very next tick.

Paged mode (``serving.page_len > 0``, reference ``engine.py:219-257``):
KV storage is a flat pool of fixed-size pages and each slot gets a
host-owned int32 page table, uploaded once per tick.  A refcounted page
allocator frees pages on eviction and allocates them on admission and at
page-boundary appends; a dry pool backpressures admission and finishes
a growing request with ``kv_capacity``.  Prefix caching shares prompt
prefixes as read-only pages, copies the last partial page on write
(COW) and prefills only the uncached delta; ``serving.prefill_chunk_len``
feeds a long delta one chunk per ``step()`` next to the decode tick.

Speculative decoding (``serving.speculate_k > 0``, reference
``engine.py:754-919, 1778-1922``): a draft model (``serving.draft``; its
own slot KV cache on either target layout) proposes k tokens per tick in
k+1 chained draft decode steps, the target scores all k+1 positions per
slot in one verify pass (the multi-query decode kernels), and each
request advances by its accepted prefix plus the bonus token.  The
proposals stay on the card between the two passes; one read-back per
pass brings the emitted tokens and accepted counts to the host.  Greedy
acceptance emits exactly the non-speculative stream.  Rollback: the slot
cache masks lengths back; the paged pool frees the pages only rejected
speculation touched.

Sampling (``serving.temperature > 0``, reference ``engine.py:178-190,
832-926``): every emission site samples ``softmax(logits / T)`` with a
``torch.Generator`` built on the engine's device from one host seed per
model call (``fold_in(seed ^ 0x5eed, n)``, ``runtime/utils.py``); the
draft samples its proposals and returns their distributions, and the
verify pass accepts by rejection sampling (``inference/speculative.py``).
Nothing is read back for it, and at temperature 0 no generator is built.

Multi-tenant LoRA (``serving.lora``, paged only, reference ``engine.py:
271-355, 929-955, 1331-1505``): ``hbm_adapter_slots + 1`` device pool
slots per target (slot 0 the zero adapter) hold the hot tenants'
factors; ``submit(adapter_id=t)`` resolves the tenant to a slot at
admission (a cold tenant is uploaded under ``Stage("adapter_fetch")``,
a dry pool parks the request), each slot's adapter index rides the tick
as an int32 table, and tenants' prompts never share prefix-cache pages.

Quantized serving (``serving.quantization``, reference ``engine.py:
182-210, 387-447, 595-607``): ``weights: "int8"`` quantizes the target's
(and the draft's) matmul weights once at build (``inference/quantize.py``)
on either layout; ``kv: "int8"`` (paged only) stores the pool as int8 rows
with fp32 scale sidecars that every prefill, decode tick, verify pass and
copy-on-write carries.  ``param_bytes`` and ``kv_bytes`` are the device
bytes the parameters and the KV caches claim, as the JAX engine counts
them.

KV tiering (``serving.kv_tier``, reference ``engine.py:576-595,
1341-1360, 2020-2050``; ``inference/kv_tier.py``): prefix-cache pages idle
for ``idle_park_ticks`` ticks are exported to host bytes (and past
``host_budget_pages`` to page files under ``disk_dir``) and released from
the pool; paged admission resumes them into fresh pages as a prefix hit.
A page's payload is its ``k``, ``v`` (and on the int8 pool ``k_scale``,
``v_scale``) slices in that order, the JAX engine's payload byte for byte.

Fault plane: the request queue is a stages :class:`Channel` and all
serving work runs under one :class:`Stage` record ("serve", points
``admit``/``prefill_chunk``/``step``), so poison/drain semantics,
graceful degradation and the ``DS_STAGE_FAULT``/``DS_STAGE_DELAY_S``
spec apply as in the JAX engine.

Telemetry (``telemetry.enabled``, reference ``engine.py:608-736,
971-1182``): a :class:`~..telemetry.hub.TelemetryHub` under
``telemetry.output_path`` gets the serve counters, gauges and
histograms, host-side spans and per-request async traces (trace.json),
one ``serve_request`` record per finished request and, every
``serving.flush_interval_ticks`` ticks, the ``serve_*`` scalars
(events.jsonl, read by ``python -m deepspeed_tpu_torch.telemetry
summarize``) and the Prometheus file.  It reads nothing back from the
card: a tick syncs exactly as it does without it.

The engine runs on ``cuda:0`` unless the caller passes ``device``; with no
CUDA device and no ``device`` it raises.  KV-page migration (the
disaggregated fleet's ``detach_kv``, ``export_pages`` and
``adopt_request``) ships each page as the JAX engine's payload, byte for
byte.

Data/tensor-parallel serving (``mesh=``, a :class:`~..parallel.mesh.Mesh`
of ``torch.distributed`` ranks; reference ``engine.py:150-268``): every
rank holds its Megatron pieces of the params (qkv and fc split by column
over heads, out and proj by row, ``wte`` by vocabulary where it divides;
int8 scales follow their weights' column split), its heads of the
caches, and — over ``data`` — a contiguous range of the slots and, paged,
of the pool's pages (each range's first page its scratch page).  Every
rank runs the same host scheduler (queue, slots, page tables, allocator,
prefix cache, adapter pool), so its decisions are replicated; the page
allocator hands a slot pages from its own rank's range only, and prefix
sharing and copy-on-write stay within a range.  A model call runs each
rank's slots through its heads (the attention kernels take heads as a
dim), the row-parallel products all-reduced over ``model``; its logits
are all-gathered over ``data`` so every rank selects (and samples, from
the same generator) over all the slots, exactly as one device does.  A
prefill runs on the data rank that owns the slot and its logits row is
broadcast over ``data``.  Page payloads (KV migration, the KV tier) are
gathered whole from the owner and are the single device's bytes.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..config.config import (DeepSpeedConfig, DeepSpeedServingConfig,
                             DeepSpeedStagesConfig,
                             DeepSpeedTelemetryConfig)
from ..config import constants as C
from ..models.gpt2 import GPT2Config, GPT2Model, _decode_attn_impl
from ..parallel import collectives as col
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, RankSharding
from ..runtime.zero import sanitize_base_spec
from ..runtime.engine_stages import wire_serve_stage_plane
from ..runtime.stages import Channel, Stage
from ..runtime.utils import fold_in, seeded_generator
from ..telemetry.cli import _percentile
from ..utils.logging import logger
from .adapters import AdapterPool, AdapterRegistry, adapter_param_shapes
from .kv_cache import (KVCacheSpec, PagedKVCacheSpec, cache_shardings,
                       paged_cache_shardings, validate_cache_mesh,
                       validate_paged_cache_mesh, init_cache,
                       init_paged_cache)
from .kv_tier import KVTier, KVTierCorruptError, disk_fsync_enabled
from .quantize import (param_nbytes, quantize_gpt2_params,
                       quantized_partition_specs)
from .scheduler import PagePool, PrefixCache, Request, SlotScheduler
from .speculative import select_next_token, speculative_accept


class _ServeConfigView:
    """The three config blocks serving needs, from a dict / json path /
    full DeepSpeedConfig — without dragging in the training-only batch
    triangle."""

    def __init__(self, src):
        if isinstance(src, DeepSpeedConfig):
            self.serving = src.serving_config
            self.telemetry = src.telemetry_config
            self.stages = src.stages_config
            return
        if isinstance(src, str):
            with open(src) as f:
                src = json.load(f)
        pd = dict(src or {})
        self.serving = DeepSpeedServingConfig(pd)
        self.telemetry = DeepSpeedTelemetryConfig(pd)
        self.stages = DeepSpeedStagesConfig(pd)


def _resolve_device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ServeEngine runs on the card by default and found no CUDA "
                "device; pass device='cpu' to serve on the CPU")
        return torch.device("cuda", 0)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"ServeEngine: device {device} requested but "
                           "CUDA is not available")
    return device


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def _place(tree, specs, mesh: Mesh):
    """This rank's piece of every leaf: a spec's axis whose dim does not
    divide falls back to replication, as in training."""
    if isinstance(tree, dict):
        return {k: _place(v, specs[k], mesh) for k, v in tree.items()}
    spec = sanitize_base_spec(tuple(specs), tuple(tree.shape), mesh)
    return RankSharding(mesh, spec).piece(tree)


#: the LoRA pools' Megatron split (pool axes A [L, N, d_in, r], B [L, N,
#: r, *out]): column-parallel targets split B's output features,
#: row-parallel ones A's input features (reference ``engine.py:296-306``)
_LORA_SPECS = {
    "qkv_w": ((), (None, None, None, None, MODEL_AXIS)),
    "out_w": ((None, None, MODEL_AXIS, None), ()),
    "fc_w": ((), (None, None, None, MODEL_AXIS)),
    "proj_w": ((None, None, MODEL_AXIS, None), ()),
}


class ServeEngine:
    """Continuous-batching decode over a GPT-2-family model.

    ``model`` exposes the serving protocol (``GPT2Model`` does):
    ``prefill``/``decode_step`` on the slot cache, ``prefill_paged``/
    ``decode_step_paged`` on the paged pool, ``verify_step``/
    ``verify_step_paged`` for speculation.  ``params`` (and
    ``draft_params``) are parameter trees of tensors, moved to ``device``;
    None draws them from ``init(seed)`` (the draft from ``seed + 1``) on
    the device.
    """

    def __init__(self, model, config=None, mesh=None, params=None,
                 seed: int = 0, device=None, draft_params=None):
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(
                f"mesh must be a deepspeed_tpu_torch.parallel.Mesh "
                f"(parallel.build_mesh), got {type(mesh).__name__}")
        self.device = _resolve_device(device)
        #: the serving mesh (None: one device) and this rank's place in it
        self.mesh = mesh
        self._mkw = {} if mesh is None else {"mesh": mesh}
        self._dp = 1 if mesh is None else mesh.axis_size(DATA_AXIS)
        self._tp = 1 if mesh is None else mesh.axis_size(MODEL_AXIS)
        self._dr = 0 if mesh is None else mesh.axis_index(DATA_AXIS)
        self.model = model
        cfg = _ServeConfigView(config)
        self.serving_config = cfg.serving
        mcfg = model.config

        self.max_seq_len = (cfg.serving.max_seq_len
                            or int(mcfg.n_positions))
        self.prefill_len = cfg.serving.prefill_len or self.max_seq_len
        if self.max_seq_len > mcfg.n_positions:
            raise ValueError(
                f"serving.max_seq_len={self.max_seq_len} exceeds the "
                f"model's n_positions={mcfg.n_positions}")
        if self.prefill_len > self.max_seq_len:
            raise ValueError(
                f"serving.prefill_len={self.prefill_len} exceeds "
                f"max_seq_len={self.max_seq_len}")
        self.slots = cfg.serving.slots
        self.eos_id_default = (None if cfg.serving.eos_id < 0
                               else cfg.serving.eos_id)
        if cfg.serving.decode_impl == "auto":
            self.decode_impl = _decode_attn_impl(mcfg)
        else:
            self.decode_impl = cfg.serving.decode_impl
        #: draft-verify speculation (0 = off)
        self.spec_k = cfg.serving.speculate_k
        #: the sampling temperature, fixed for the engine's lifetime (0 =
        #: greedy: no generator is ever built)
        self.temperature = cfg.serving.temperature
        #: one host seed per sampling model call: fold_in(base, n)
        self._rng_base = (seed ^ 0x5eed) if self.temperature > 0 else None
        self._rng_n = 0
        self._spec_proposed_n = 0
        self._spec_accepted_n = 0
        self._spec_passes = 0
        #: the quantized serving plane: both arms are fixed for the
        #: engine's lifetime
        q = cfg.serving.quantization
        self.quant_weights = q[C.SERVING_QUANT_WEIGHTS] == "int8"
        self.quant_kv = q[C.SERVING_QUANT_KV] == "int8"

        # -- params + cache on the device ---------------------------------
        if params is None:
            params = model.init(seed, device=self.device)
        self.params = _to_device(params, self.device)
        if self.quant_weights:
            # one-shot post-load quantization: the engine keeps only the
            # int8 weights and their fp32 scale rows
            self.params = quantize_gpt2_params(self.params)
        # the whole tree's bytes, as the JAX engine counts a sharded one
        self.param_bytes = param_nbytes(self.params)
        if mesh is not None:
            pspecs = model.param_partition_specs(self.params)
            if self.quant_weights:
                pspecs = quantized_partition_specs(pspecs)
            self.params = _place(self.params, pspecs, mesh)
        kv_dtype = self.params["wte"].dtype
        self.page_len = cfg.serving.page_len
        self.paged = self.page_len > 0
        #: chunked prefill (Sarathi-Serve, PAPERS.md): > 0 = prompts with
        #: a longer uncached delta admit at once and prefill one chunk per
        #: step(), next to the decode tick (the config requires paged)
        self.prefill_chunk_len = (cfg.serving.prefill_chunk_len
                                  if self.paged else 0)
        if self.quant_kv and not self.paged:
            raise ValueError(
                "serving.quantization.kv='int8' requires a paged cache "
                "(serving.page_len > 0); the slot layout keeps the "
                "master dtype")
        if self.paged:
            self.max_pages = -(-self.max_seq_len // self.page_len)
            # 0 = capacity-neutral: every slot can reach max_seq_len, plus
            # the scratch page, rounded up to the data width so each data
            # rank holds an equal range
            pages = cfg.serving.pages
            if pages == 0:
                pages = 1 + self.slots * self.max_pages
                pages += (-pages) % self._dp
            self.cache_spec = PagedKVCacheSpec(
                layers=mcfg.n_layer, slots=self.slots, heads=mcfg.n_head,
                pages=pages, page_len=self.page_len, head_dim=mcfg.d_head,
                max_pages=self.max_pages,
                dtype=torch.int8 if self.quant_kv else kv_dtype,
                quant=self.quant_kv)
            shardings = None
            if mesh is not None:
                validate_paged_cache_mesh(mesh, self.cache_spec)
                if self.slots % self._dp:
                    # each data rank serves a contiguous slot range from
                    # its own page range: a remainder slot has no rank
                    raise ValueError(
                        f"serving.slots={self.slots} must be divisible by "
                        f"the mesh's data axis ({self._dp}) on the paged "
                        "layout: each data rank serves an equal range of "
                        "slots from its own range of pages")
                shardings = paged_cache_shardings(mesh, self.quant_kv)
            self.cache = init_paged_cache(self.cache_spec, self.device,
                                          shardings)
            self.pool = PagePool(pages, parts=self._dp)
            #: this data rank's page range starts here
            self._p0 = self._dr * self.pool.part_pages
            self.prefix = (PrefixCache(self.page_len, self.pool)
                           if cfg.serving.prefix_cache else None)
            #: host-owned page tables, one row per slot; dead entries hold
            #: the scratch page (a valid index, masked data)
            self._table = np.zeros((self.slots, self.max_pages), np.int32)
        else:
            self.pool = None
            self.prefix = None
            self.cache_spec = KVCacheSpec(
                layers=mcfg.n_layer, slots=self.slots, heads=mcfg.n_head,
                max_len=self.max_seq_len, head_dim=mcfg.d_head,
                dtype=kv_dtype)
            shardings = None
            if mesh is not None:
                validate_cache_mesh(mesh, self.cache_spec)
                shardings = cache_shardings(mesh)
            self.cache = init_cache(self.cache_spec, self.device, shardings)
        #: this data rank's slots: [_s0, _s0 + _sl)
        self._sl = self.slots // self._dp
        self._s0 = self._dr * self._sl
        self._logits_dtype = kv_dtype
        self._build_lora_plane(cfg, mcfg, kv_dtype)
        if self.spec_k:
            self._build_spec_plane(cfg, mcfg, draft_params, seed)

        # -- memory planes: the device bytes the params and KV caches
        # claim (reference engine.py:595-607), whole as the JAX engine
        # counts them under a mesh
        self.kv_bytes = self.cache_spec.bytes
        if self.spec_k:
            self.param_bytes += self._draft_param_bytes
            self.kv_bytes += self.draft_cache_spec.bytes

        # -- fault plane: queue as a Channel, work under one Stage -------
        self.queue = Channel(capacity=cfg.serving.queue_capacity)
        self.scheduler = SlotScheduler(self.slots)
        self.stage = Stage(
            "serve", max_failures=cfg.stages.max_stage_failures,
            fallback="chaos-free direct serving (injection plane "
                     "bypassed)")
        # flight recorder: every stage event samples the queue depth (and,
        # paged, the free pages; speculating, the live accept ratio)
        self.stage.depth_fn = (self._stage_depth if self.paged
                               or self.spec_k else self.queue.qsize)
        self.stage.on_degrade = lambda st: self.dump_flight_record(
            reason=f"stage {st.name!r} degraded to {st.fallback}")

        # -- KV tiering: park idle sessions' prefix-cache pages on host
        # and disk, stream them back on resume.  Off by default
        # (idle_park_ticks=0): the engine is then what it was without it
        self.kv_tier = None
        kvt = cfg.serving.kv_tier
        if self.paged and self.prefix is not None \
                and kvt[C.SERVING_KV_TIER_IDLE_PARK_TICKS] > 0:
            disk_dir = kvt[C.SERVING_KV_TIER_DISK_DIR] or None
            if disk_dir and mesh is not None and mesh.size > 1:
                # every rank parks the same pages (the gathered payloads
                # are equal): each writes its own copy of the files
                disk_dir = os.path.join(disk_dir, f"rank{mesh.rank}")
            self.kv_tier = KVTier(
                page_len=self.page_len, pool=self.pool,
                prefix=self.prefix,
                exporter=self._export_page_bytes,
                importer=self._import_page_bytes,
                idle_park_ticks=kvt[C.SERVING_KV_TIER_IDLE_PARK_TICKS],
                host_budget_pages=kvt[
                    C.SERVING_KV_TIER_HOST_BUDGET_PAGES],
                disk_dir=disk_dir,
                fsync=disk_fsync_enabled(kvt[C.SERVING_KV_TIER_FSYNC]),
                max_failures=cfg.stages.max_stage_failures)
        wire_serve_stage_plane(self)
        self._build_telemetry(cfg)

        #: perf_counter epoch of the completion records' ``arrival_s``
        self._epoch_t = time.perf_counter()
        self._rid = 0
        #: engine ticks (``step`` calls): the KV tier's idleness clock
        self._ticks = 0
        #: decode ticks that ran the model (each launches the decode
        #: kernel, slot or paged, once per layer)
        self.decode_ticks = 0
        #: speculative ticks that ran the verify pass (each launches the
        #: multi-query kernel once per target layer and the draft's decode
        #: kernel k+1 times per draft layer)
        self.verify_ticks = 0
        self._closed = False
        #: requests popped from the queue but not yet admitted — the
        #: page-pool (and adapter-pool) backpressure parking spot
        #: (admission order kept)
        self._pending: deque = deque()
        self._latencies: deque = deque(maxlen=8192)
        #: decode-phase (post-first-token) latencies only: the TPOT window
        self._tpot_lat: deque = deque(maxlen=2048)
        self._flush_every = cfg.serving.flush_interval_ticks
        self._last_flush_t = time.perf_counter()
        self._last_flush_tokens = 0
        self._tokens_seen = 0

    # -- multi-tenant LoRA: the adapter plane ----------------------------
    def _build_lora_plane(self, cfg, mcfg, kv_dtype) -> None:
        """The adapter pools, registry and residency pool (reference
        ``engine.py:271-355``): per target, A ``[L, N, d_in, r]`` and B
        ``[L, N, r, *out]`` in the master dtype with ``N =
        hbm_adapter_slots + 1`` (slot 0 the zero adapter, never written),
        and a host int32 table of each decode slot's pool slot.  rank 0
        (the default): no pools, and every model call runs exactly the
        code without adapters."""
        lcfg = cfg.serving.lora
        self.lora_rank = int(lcfg[C.SERVING_LORA_RANK])
        self.lora = self.lora_rank > 0
        self.lora_scale = (float(lcfg[C.SERVING_LORA_ALPHA]) / self.lora_rank
                           if self.lora else 1.0)
        self.adapters = None
        self.adapter_bytes = 0
        self._adapter_table = None
        self._adapter_hits_seen = 0
        self._adapter_faults_seen = 0
        if not self.lora:
            return
        self.lora_targets = tuple(lcfg[C.SERVING_LORA_TARGETS])
        n_aslots = int(lcfg[C.SERVING_LORA_HBM_SLOTS])
        self._lora_shapes = adapter_param_shapes(
            mcfg.n_layer, mcfg.d_model, self.lora_rank, self.lora_targets)
        self._lora_pools = {}
        #: each factor's split (pool specs; the mesh's, else whole)
        self._lora_shardings = {}
        nbytes = torch.empty((), dtype=kv_dtype).element_size()
        self.adapter_bytes = 0
        for t in self.lora_targets:
            shards = tuple(RankSharding(self.mesh, spec)
                           if self.mesh is not None else None
                           for spec in _LORA_SPECS[t])
            self._lora_shardings[t] = shards
            pools = []
            for shp, sh in zip(self._lora_shapes[t], shards):
                full = (shp[0], n_aslots + 1) + tuple(shp[1:])
                self.adapter_bytes += int(np.prod(full)) * nbytes
                pools.append(torch.zeros(
                    full if sh is None else sh.shard_shape(full),
                    dtype=kv_dtype, device=self.device))
            self._lora_pools[t] = tuple(pools)
        self.adapter_registry = AdapterRegistry(
            int(lcfg[C.SERVING_LORA_MAX_ADAPTERS]), self._lora_shapes)
        self.adapter_stage = Stage(
            "adapter_fetch", max_failures=cfg.stages.max_stage_failures,
            fallback="synchronous host->HBM adapter copy (injection "
                     "plane bypassed)")
        self.adapters = AdapterPool(n_aslots, self.adapter_registry,
                                    self._upload_adapter,
                                    stage=self.adapter_stage)
        #: host-owned per-slot adapter table, uploaded once a tick (dead
        #: slots hold 0: the zero adapter's delta is exact zeros)
        self._adapter_table = np.zeros((self.slots,), np.int32)

    def _upload_adapter(self, slot: int, weights) -> None:
        """Host->device copy of one adapter into pool slot ``slot`` of
        every target (reference ``engine.py:929-939``): each factor cast
        to the pool's dtype on the host (round to nearest even, as the
        reference's ``astype``) and copied in place — synchronous, under
        the ``adapter_fetch`` stage's ``fetch`` point."""
        for t in self.lora_targets:
            for pool, w, sh in zip(self._lora_pools[t], weights[t],
                                   self._lora_shardings[t]):
                w = torch.from_numpy(np.ascontiguousarray(w, np.float32))
                if sh is not None:
                    # the rank's piece: the pool spec without its slot dim
                    w = RankSharding(sh.mesh, sh.spec[:1] + sh.spec[2:]
                                     ).piece(w)
                pool[:, slot].copy_(w.to(pool.dtype))

    def register_adapter(self, adapter_id: int, weights=None):
        """Register a tenant adapter (host-side).  ``weights=None``
        synthesizes deterministic factors from the adapter id, so every
        replica derives identical weights for the same tenant without
        shipping bytes (reference ``engine.py:941-950``)."""
        if not self.lora:
            raise ValueError("serving.lora.rank is 0 — adapters disabled")
        if weights is None:
            return self.adapter_registry.get(adapter_id)
        return self.adapter_registry.register(adapter_id, weights)

    def _lora_kw(self, slots) -> Dict[str, Any]:
        """The LoRA keyword arguments of the model's paged functions for
        ``slots`` (a device int tensor, or an int for a prefill); none
        with lora off."""
        if not self.lora:
            return {}
        return {"lora": self._lora_pools, "adapter_slots": slots,
                "lora_scale": self.lora_scale}

    def _adapter_slots(self) -> Optional[torch.Tensor]:
        """This tick's per-slot adapter table on the device (lora only),
        this rank's slots of it."""
        if not self.lora:
            return None
        return torch.from_numpy(self._rows(self._adapter_table)).to(
            self.device)

    # -- the serving mesh: which rank holds which slots and pages ---------
    def _rows(self, t):
        """This data rank's slots' rows of a per-slot array [S, ...] (all
        of them without a data split)."""
        return t if self._dp == 1 else t[self._s0:self._s0 + self._sl]

    def _all_slots(self, t: torch.Tensor) -> torch.Tensor:
        """A model call's per-slot outputs [S/dp, ...] all-gathered over
        ``data``: every rank then holds every slot's."""
        return t if self.mesh is None else col.all_gather(t, self.mesh,
                                                          DATA_AXIS)

    def _owner(self, slot: int) -> int:
        """The data rank that serves ``slot``."""
        return slot // self._sl

    def _from_owner(self, t: torch.Tensor, owner: int) -> torch.Tensor:
        """Data rank ``owner``'s ``t`` on every rank (the others' ``t``
        gives shape and dtype)."""
        if self.mesh is None:
            return t
        return col.pbroadcast_from(t, self.mesh, DATA_AXIS, owner)

    def _local_pages(self, pages):
        """Page ids (a table, a row or a list) as this rank's pool
        indices: its own range shifted to 0, anything else (dead entries)
        its scratch page."""
        a = np.asarray(pages)
        if self._dp == 1:
            return a
        return np.where((a >= self._p0)
                        & (a < self._p0 + self.pool.part_pages),
                        a - self._p0, 0).astype(a.dtype)

    def _table_dev(self) -> torch.Tensor:
        """This rank's rows of the page tables, in its pool indices."""
        return torch.from_numpy(np.ascontiguousarray(
            self._local_pages(self._rows(self._table)))).to(self.device)

    def _part(self, slot: int) -> int:
        """The page range (data rank) a slot's pages come from."""
        return self._owner(slot) if self.paged else 0

    # -- sampling: one generator per model call --------------------------
    def _next_seed(self) -> Optional[int]:
        """The next model call's host seed (reference ``_maybe_key``,
        ``engine.py:920-926``): None at temperature 0, where nothing
        samples."""
        if self._rng_base is None:
            return None
        self._rng_n += 1
        return fold_in(self._rng_base, self._rng_n)

    def _generator(self, seed: Optional[int]):
        """A ``torch.Generator`` on the engine's device seeded from a host
        seed; None for None (greedy)."""
        return None if seed is None else seeded_generator(seed, self.device)

    def _select(self, logits: torch.Tensor) -> torch.Tensor:
        """One emission site's next tokens: greedy, or sampled with the
        next call's generator."""
        return select_next_token(logits, self.temperature,
                                 self._generator(self._next_seed()))

    # -- telemetry ---------------------------------------------------------
    def _build_telemetry(self, cfg) -> None:
        """The hub and the serve registry metrics (reference ``engine.py:
        608-731``).  Off (the default): ``self.telemetry`` is None and
        every hook below is a no-op."""
        self.telemetry = None
        if not cfg.telemetry.enabled:
            return
        from ..telemetry.hub import TelemetryHub
        out = cfg.telemetry.output_path or os.path.join(os.getcwd(),
                                                        "telemetry")
        self.telemetry = TelemetryHub(
            out, trace=cfg.telemetry.trace,
            compile_events=cfg.telemetry.compile_events,
            memory=cfg.telemetry.memory,
            storm_threshold=cfg.telemetry.recompile_storm_threshold,
            device=self.device)
        # the reference tracks each compiled program's retraces; eager
        # torch compiles none, so each track() returns False
        programs = {"decode_step": self._decode_tick,
                    "prefill": self._admit_one}
        if self.paged:
            programs["copy_page"] = self._copy_page
            programs["page_out"] = self._export_page_bytes
            programs["page_in"] = self._import_page_bytes
        if self.spec_k:
            programs.update(verify_step=self._verify,
                            draft_propose=self._propose,
                            draft_prefill=self._draft_prefill)
        if self.lora:
            programs["adapter_upload"] = self._upload_adapter
        for name, fn in programs.items():
            self.telemetry.track_program(name, fn)
        reg = self.telemetry.registry
        self._tokens_total = reg.counter(
            "serve_tokens_total", "generated tokens")
        self._requests_total = reg.counter(
            "serve_requests_total", "finished requests")
        self._requests_failed = reg.counter(
            "serve_requests_failed_total",
            "requests finished with an error")
        self._token_seconds = reg.histogram(
            "serve_token_seconds",
            "per-token latency (first token = time to first token)")
        self._ttft_hist = reg.histogram(
            "serve_ttft_seconds",
            "time to first token: submit -> first generated token "
            "(queue wait + prefill)")
        self._queue_wait_hist = reg.histogram(
            "serve_queue_wait_seconds",
            "submit -> slot admission wait (the Orca iteration-"
            "level scheduling number)")
        self._active_gauge = reg.gauge(
            "serve_active_slots", "slots decoding this tick")
        reg.gauge("serve_param_bytes",
                  "device bytes of the serving params (target + draft; "
                  "int8 weights + scales under quantization)").set(
                      self.param_bytes)
        reg.gauge("serve_kv_bytes",
                  "device bytes of the KV cache from its spec (both "
                  "layouts; incl. quant scale sidecars + draft cache)").set(
                      self.kv_bytes)
        if self.paged:
            reg.gauge("serve_pages_total",
                      "allocatable KV pages (excludes the scratch page)"
                      ).set(self.cache_spec.pages - 1)
            self._free_pages_gauge = reg.gauge(
                "serve_free_pages", "unallocated KV pages")
            self._free_pages_gauge.set(self.pool.free_count)
            self._prefix_hits = reg.counter(
                "serve_prefix_hits_total",
                "admissions that reused cached prefix pages")
            self._prefix_misses = reg.counter(
                "serve_prefix_misses_total",
                "admissions that found no cached prefix")
        if self.spec_k:
            self._spec_proposed = reg.counter(
                "serve_spec_proposed_total",
                "draft tokens proposed to the verify program")
            self._spec_accepted_ctr = reg.counter(
                "serve_spec_accepted_total",
                "accepted draft tokens actually emitted")
            self._spec_len_hist = reg.histogram(
                "serve_spec_accepted_len",
                "tokens emitted per verify pass (accepted draft "
                "prefix + the bonus token)")
        if self.lora:
            self._adapters_resident_gauge = reg.gauge(
                "serve_adapters_resident",
                "tenant adapters resident in HBM pool slots "
                "(pinned + cold-evictable; excludes the reserved "
                "zero adapter)")
            self._adapter_hits_ctr = reg.counter(
                "serve_adapter_hits_total",
                "admissions whose adapter was already HBM-resident")
            self._adapter_faults_ctr = reg.counter(
                "serve_adapter_faults_total",
                "cold-adapter admissions that fetched host->HBM "
                "(the adapter_fetch stage point)")
        if self.kv_tier is not None:
            self._kv_parked_gauge = reg.gauge(
                "serve_kv_parked_sessions",
                "idle sessions parked off HBM in the host/disk KV "
                "tier (parked digest-chain tails)")
            self._kv_spill_ctr = reg.counter(
                "serve_kv_spill_bytes_total",
                "KV page bytes exported HBM -> host/disk by the "
                "kv_spill stage")
            self._kv_fetch_ctr = reg.counter(
                "serve_kv_fetch_bytes_total",
                "parked KV page bytes streamed back on session "
                "resume by the kv_fetch stage")
            self._kv_spill_seen = 0
            self._kv_fetch_seen = 0

        def _stage_counter(name, help, n):
            reg.counter(name, help).inc(n)

        self.stage.counter_fn = _stage_counter
        if self.lora:
            self.adapter_stage.counter_fn = _stage_counter
        if self.kv_tier is not None:
            self.kv_tier.spill_stage.counter_fn = _stage_counter
            self.kv_tier.fetch_stage.counter_fn = _stage_counter

    # -- speculative decoding: the draft plane --------------------------
    def _build_spec_plane(self, cfg, mcfg, draft_params, seed: int) -> None:
        """The draft model and its slot KV cache (reference
        ``_build_spec_plane``, ``engine.py:754-919``).  The draft always
        runs the fixed-stride slot cache in the master dtype, paged or
        int8 target pool or not: at draft scale a full stride is small next
        to the target pool, and its rollback stays a lengths mask.  With
        the weights arm on, the draft's weights are quantized too."""
        d = cfg.serving.draft
        draft_cfg = GPT2Config(
            vocab_size=mcfg.vocab_size, n_positions=mcfg.n_positions,
            d_model=d[C.SERVING_DRAFT_D_MODEL],
            n_layer=d[C.SERVING_DRAFT_N_LAYER],
            n_head=d[C.SERVING_DRAFT_N_HEAD], remat=None,
            attn_impl=d[C.SERVING_DRAFT_ATTN_IMPL] or mcfg.attn_impl)
        self.draft_model = GPT2Model(draft_cfg)
        self._draft_impl = ("dense" if self.decode_impl == "dense"
                            else _decode_attn_impl(draft_cfg))
        if draft_params is None:
            draft_params = self.draft_model.init(
                seed + 1, device=self.device,
                dtype=self.params["wte"].dtype)
        self.draft_params = _to_device(draft_params, self.device)
        if self.quant_weights:
            self.draft_params = quantize_gpt2_params(self.draft_params)
        self._draft_param_bytes = param_nbytes(self.draft_params)
        self.draft_cache_spec = KVCacheSpec(
            layers=draft_cfg.n_layer, slots=self.slots,
            heads=draft_cfg.n_head, max_len=self.max_seq_len,
            head_dim=draft_cfg.d_head,
            dtype=self.draft_params["wte"].dtype)
        shardings = None
        if self.mesh is not None:
            validate_cache_mesh(self.mesh, self.draft_cache_spec)
            shardings = cache_shardings(self.mesh)
            pspecs = self.draft_model.param_partition_specs(
                self.draft_params)
            if self.quant_weights:
                pspecs = quantized_partition_specs(pspecs)
            self.draft_params = _place(self.draft_params, pspecs,
                                       self.mesh)
        self._draft_cache = init_cache(self.draft_cache_spec, self.device,
                                       shardings)

    def _spec_ratio(self) -> float:
        """The live draft-acceptance ratio (reference ``engine.py:957``)."""
        return round(
            self._spec_accepted_n / max(self._spec_proposed_n, 1), 4)

    def _stage_depth(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"depth": self.queue.qsize()}
        if self.paged:
            d["free_pages"] = self.pool.free_count
        if self.spec_k:
            d["spec_accept_ratio"] = self._spec_ratio()
        return d

    # -- telemetry helpers ----------------------------------------------
    def _span(self, name: str, **args):
        """A host-side trace span (reference ``engine.py:972``); a no-op
        context with telemetry off."""
        if self.telemetry is None:
            return contextlib.nullcontext()
        return self.telemetry.span(name, cat="serve", **args)

    @property
    def _tracer(self):
        tel = self.telemetry
        return tel.tracer if tel is not None else None

    # -- per-request causal trace + completion record ---------------------
    def _begin_request_trace(self, req: Request) -> None:
        """Open the request's async ``serve/request`` and
        ``serve/queue_wait`` spans (reference ``engine.py:983-997``)."""
        tr = self._tracer
        if tr is None:
            return
        from ..telemetry.tracing import TraceContext
        req.ctx = TraceContext.new()
        req.span = tr.async_begin("serve/request", req.ctx.trace_id,
                                  cat="serve", rid=req.rid)
        req.queue_span = tr.async_begin("serve/queue_wait",
                                        req.ctx.trace_id, cat="serve",
                                        rid=req.rid)

    def _end_queue_wait(self, req: Request) -> None:
        """Admission: the queue-wait span ends and its histogram observes
        submit -> admission."""
        if req.queue_span is not None:
            req.queue_span.end()
            req.queue_span = None
        if self.telemetry is not None:
            self._queue_wait_hist.observe(req.admit_t - req.submit_t)

    def _flow(self, kind: str, req: Request, **args) -> None:
        """One ``serve/request`` flow event of ``req`` (``start`` in its
        prefill span, ``step`` in each tick's span)."""
        tr = self._tracer
        if tr is not None and req.ctx is not None:
            getattr(tr, "flow_" + kind)("serve/request", req.ctx,
                                        cat="serve", rid=req.rid, **args)

    def _end_request_trace(self, req: Request, reason=None,
                           error=None) -> None:
        """Close the request's spans and end its flow inside a
        ``serve/finish`` (or ``serve/error``) span (reference
        ``engine.py:999-1025``)."""
        tr = self._tracer
        args = {}
        if reason is not None:
            args["reason"] = reason
        if error is not None:
            args["error"] = repr(error)
        if req.queue_span is not None:  # never admitted: close it now
            req.queue_span.end(**args)
            req.queue_span = None
        if tr is not None and req.ctx is not None:
            name = "serve/error" if error is not None else "serve/finish"
            with tr.span(name, cat="serve", rid=req.rid, **args):
                if req.admit_t:
                    # the flow starts at admission: a request that failed
                    # in the queue has none to end
                    tr.flow_end("serve/request", req.ctx, cat="serve",
                                rid=req.rid)
            req.ctx = None
        if req.span is not None:
            req.span.end(**args)
            req.span = None

    def _write_request_record(self, req: Request) -> None:
        """One ``serve_request`` record per request in events.jsonl
        (reference ``engine.py:1027-1058``)."""
        if self.telemetry is None:
            return
        decode = [float(t) for t in req.token_times[1:]]
        rec = {
            "rid": req.rid,
            "prompt_len": len(req.prompt),
            "arrival_s": round(req.submit_t - self._epoch_t, 6),
            "tokens": len(req.tokens),
            "finish_reason": req.finish_reason,
            "error": repr(req.error) if req.error is not None else None,
            "total_s": time.perf_counter() - req.submit_t,
            "queue_wait_s": (req.admit_t - req.submit_t
                             if req.admit_t else None),
            "ttft_s": (float(req.token_times[0])
                       if req.token_times else None),
            "prefill_s": req.prefill_s if req.prefill_s else None,
            "decode_tokens": len(decode),
            "decode_s_sum": sum(decode),
            "token_times_s": [round(t, 6) for t in decode[:512]],
        }
        if req.ctx is not None:
            rec["trace_id"] = req.ctx.trace_id
        self.telemetry.jsonl.write_event("serve_request", rec)

    def dump_flight_record(self, reason: str = "manual", error=None):
        """Dump the ``serve`` stage's event ring as
        ``flightrec_<tick>.json`` (reference ``engine.py:1060-1082``):
        fired on poison and degradation, callable on demand; never
        raises, and None with telemetry off."""
        if self.telemetry is None:
            return None
        try:
            extra = {"active_slots": len(self.scheduler.active),
                     "queued": self.queue.qsize()}
            if self.paged:
                extra["free_pages"] = self.pool.free_count
                extra["pending"] = len(self._pending)
            if self.spec_k:
                extra["spec_accept_ratio"] = self._spec_ratio()
            return self.telemetry.dump_flight_record(
                {"serve": self.stage}, self._ticks, reason, error=error,
                extra=extra)
        except Exception:
            logger.exception("serve flight-record dump failed "
                             "(reason=%r)", reason)
            return None

    def _count_token(self, latency_s: float) -> None:
        self._tokens_seen += 1
        self._latencies.append(latency_s)
        if self.telemetry is not None:
            self._tokens_total.inc()
            self._token_seconds.observe(latency_s)

    def _flush(self) -> None:
        """The serving scalars as one telemetry sync event (reference
        ``engine.py:1091-1174``; the summarize CLI's serving rows read
        exactly these).  Host counters only — the memory sampler here is
        the one device-side read, and it reads allocator bookkeeping."""
        if self.telemetry is None:
            return
        now = time.perf_counter()
        dt = max(now - self._last_flush_t, 1e-9)
        toks = self._tokens_seen - self._last_flush_tokens
        lat = sorted(self._latencies)
        scalars = {"serve_tokens_per_s": toks / dt,
                   "serve_param_bytes": float(self.param_bytes),
                   "serve_kv_bytes": float(self.kv_bytes)}
        p50 = _percentile(lat, 0.50)
        p99 = _percentile(lat, 0.99)
        if p50 is not None:
            scalars["serve_token_p50_s"] = p50
            scalars["serve_token_p99_s"] = p99
        tpot = self.tpot_p99()
        if tpot is not None:
            scalars["serve_tpot_p99_s"] = tpot
        if self.paged:
            usable = self.cache_spec.pages - 1
            scalars["serve_free_pages"] = float(self.pool.free_count)
            scalars["serve_page_utilization"] = (
                self.pool.used_count / usable if usable else 0.0)
            if self.prefix is not None:
                tot = self.prefix.hits + self.prefix.misses
                if tot:
                    scalars["serve_prefix_hit_ratio"] = \
                        self.prefix.hits / tot
                scalars["serve_prefix_hit_tokens"] = \
                    float(self.prefix.hit_tokens)
                scalars["serve_page_cow_total"] = float(self.prefix.cow)
        if self.spec_k and self._spec_passes:
            scalars["serve_spec_accept_ratio"] = self._spec_ratio()
            scalars["serve_spec_mean_accepted_len"] = (
                (self._spec_accepted_n + self._spec_passes)
                / self._spec_passes)
        if self.lora:
            pool = self.adapters
            scalars["serve_adapters_resident"] = float(pool.resident())
            scalars["serve_adapter_bytes"] = float(self.adapter_bytes)
            scalars["serve_adapter_hits_total"] = float(pool.hits)
            scalars["serve_adapter_faults_total"] = float(pool.faults)
            scalars["serve_adapter_evictions_total"] = \
                float(pool.evictions)
            self._adapters_resident_gauge.set(pool.resident())
            # counters advance by the pool's deltas since the last flush;
            # the cumulative scalars above stay the summarize source
            self._adapter_hits_ctr.inc(pool.hits - self._adapter_hits_seen)
            self._adapter_faults_ctr.inc(
                pool.faults - self._adapter_faults_seen)
            self._adapter_hits_seen = pool.hits
            self._adapter_faults_seen = pool.faults
        if self.kv_tier is not None:
            tier = self.kv_tier
            scalars["serve_kv_parked_sessions"] = \
                float(tier.parked_sessions)
            scalars["serve_kv_spill_bytes_total"] = float(tier.spill_bytes)
            scalars["serve_kv_fetch_bytes_total"] = float(tier.fetch_bytes)
            p99r = tier.resume_p99_s()
            if p99r is not None:
                scalars["serve_kv_resume_p99_s"] = p99r
            self._kv_parked_gauge.set(tier.parked_sessions)
            self._kv_spill_ctr.inc(tier.spill_bytes - self._kv_spill_seen)
            self._kv_fetch_ctr.inc(tier.fetch_bytes - self._kv_fetch_seen)
            self._kv_spill_seen = tier.spill_bytes
            self._kv_fetch_seen = tier.fetch_bytes
        self.telemetry.on_sync(step=self._ticks, scalars=scalars)
        self._last_flush_t = now
        self._last_flush_tokens = self._tokens_seen

    def hot_adapters(self) -> List[int]:
        """Adapter ids resident in device pool slots (the replica
        heartbeat's tenant-affinity gauge)."""
        return self.adapters.hot_ids() if self.lora else []

    def tpot_p99(self) -> Optional[float]:
        """Decode-phase p99 latency per token (TPOT) over the recent
        window."""
        if not self._tpot_lat:
            return None
        return _percentile(sorted(self._tpot_lat), 0.99)

    # -- request intake ---------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 16,
               eos_id: Optional[int] = None,
               detach_kv: bool = False,
               adapter_id: int = 0) -> Request:
        """Enqueue one generation request (blocks on a full queue — the
        open-loop backpressure point).  The first generated token comes
        from the prefill logits.  ``adapter_id`` selects the tenant's LoRA
        adapter (0 = the base model; needs ``serving.lora.rank > 0``);
        admission resolves it to a device pool slot, parking on a dry pool
        like a pages-dry admission.

        ``detach_kv`` (paged only) marks a KV-migration source: when the
        request finishes, its pages stay alive for :meth:`export_pages`
        instead of freeing — the disaggregated fleet's prefill leg
        (``release_detached`` frees them after the transfer)."""
        if self._closed:
            raise RuntimeError("ServeEngine is closed")
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) > self.prefill_len:
            raise ValueError(
                f"prompt length {len(prompt)} exceeds the static "
                f"serving.prefill_len bucket ({self.prefill_len}); "
                "raise the bucket or truncate the prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.paged:
            need = -(-len(prompt) // self.page_len)
            usable = self.cache_spec.pages - 1
            if need > usable:
                raise ValueError(
                    f"prompt needs {need} KV pages but the pool only "
                    f"has {usable} allocatable pages "
                    f"(serving.pages={self.cache_spec.pages}, page 0 "
                    "reserved); it could never be admitted")
        if detach_kv and not self.paged:
            raise ValueError(
                "detach_kv (KV-migration handoff) requires the paged "
                "layout (serving.page_len > 0)")
        adapter_id = int(adapter_id)
        if adapter_id < 0:
            raise ValueError("adapter_id must be >= 0 (0 = base model)")
        if adapter_id > 0 and not self.lora:
            raise ValueError(
                f"adapter_id={adapter_id} but multi-tenant LoRA is off "
                "(set serving.lora.rank > 0)")
        self._rid += 1
        req = Request(rid=self._rid, prompt=prompt,
                      max_new_tokens=int(max_new_tokens),
                      eos_id=(self.eos_id_default if eos_id is None
                              else int(eos_id)),
                      submit_t=time.perf_counter())
        req.adapter_id = adapter_id
        req.detach_kv = bool(detach_kv)
        self._begin_request_trace(req)
        # Deliberate submission-side backpressure: submit() runs on the
        # caller's thread, and a full queue must block the caller (and a
        # closed one must reject) — the admission contract.
        # jaxlint: disable=JL008
        if not self.queue.put(req):
            err = self.queue.err
            rej = RuntimeError(
                "serve queue rejected the request (engine closed or "
                f"poisoned){': ' + repr(err) if err else ''}")
            req.error = rej
            self._end_request_trace(req, error=rej)
            raise rej
        return req

    def _pop_request(self) -> Optional[Request]:
        with self.queue.cond:
            if self.queue.items:
                item = self.queue.items.pop(0)
                self.queue.cond.notify_all()
                return item
            if self.queue.err is not None:
                raise self.queue.err
            return None

    # -- KV-page migration (disaggregated fleet) --------------------------
    def page_leaf_nbytes(self) -> List[int]:
        """Per-leaf byte lengths inside ONE exported page payload — the
        binary frame header's validation contract (both ends of a
        migration run the same config, so these must agree).  A page's
        payload holds every head, whatever the mesh."""
        return [self.cache[k][:, 0].numel() * self.cache[k].element_size()
                * self._tp for k in self._page_leaves()]

    def export_pages(self, req: Request) -> List[bytes]:
        """A finished ``detach_kv`` request's KV pages as raw bytes, one
        payload per page: the page's leaf slices (``[:, pid]``)
        concatenated in ``_page_leaves`` order, the JAX engine's payload
        byte for byte.  Whole pages ship (a partial tail's dead rows are
        masked by lengths on the importing side).  Each leaf's pages are
        gathered in one device copy and read back in one.  Call
        :meth:`release_detached` after the payloads hit the wire."""
        if not self.paged or not req.pages:
            raise RuntimeError(
                "export_pages needs a paged engine and a finished "
                "detach_kv request still holding its pages")
        with self._span("serve/page_out", rid=req.rid,
                        pages=len(req.pages)):
            return self._export_pages(req.pages)

    def release_detached(self, req: Request) -> None:
        """Drop the pages a ``detach_kv`` finish kept alive — the
        export's payloads are on the wire, the pages are admissible
        capacity again."""
        self._release_pages(req)

    def adopt_request(self, prompt, first_token: int,
                      max_new_tokens: int,
                      eos_id: Optional[int],
                      page_payloads: List[bytes],
                      adapter_id: int = 0) -> Optional[Request]:
        """Adopt a migrated request mid-decode (docs/serving.md
        "disaggregated fleet"): import its exported KV pages into freshly
        allocated local pages (page ids are replica-local — the table is
        rebuilt), restore the slot's cache length, and resume decoding
        from ``first_token`` on the next tick.  The page count, the
        adapter and every payload's size are checked before any page is
        allocated or any byte lands.  Returns None when no slot, pages or
        adapter slot are free yet — the caller parks and retries, the
        same backpressure contract as admission."""
        if not self.paged:
            raise RuntimeError("KV adoption requires the paged layout")
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        need = -(-len(prompt) // self.page_len)
        if need != len(page_payloads):
            raise ValueError(
                f"migrated request ships {len(page_payloads)} pages "
                f"but a {len(prompt)}-token prompt needs {need}")
        adapter_id = int(adapter_id)
        if adapter_id > 0 and not self.lora:
            raise ValueError(
                f"migrated request carries adapter_id={adapter_id} but "
                "multi-tenant LoRA is off on this replica")
        page_nb = sum(self.page_leaf_nbytes())
        for payload in page_payloads:
            if len(payload) != page_nb:
                raise ValueError(
                    f"migrated page payload is {len(payload)} bytes; this "
                    f"pool's page is {page_nb} (config mismatch between "
                    "migration endpoints)")
        if not self.scheduler.has_free():
            return None
        pages = self._alloc_pages(need, self._part(self.scheduler.free[0]))
        if pages is None:
            return None
        aslot = 0
        if self.lora and adapter_id:
            # same ordering as admission: adapter pin AFTER page alloc,
            # pool-dry parks (deterministic synthesis means this replica
            # derives the identical weights locally — no adapter bytes
            # ride the migration payload)
            try:
                got = self.adapters.acquire(adapter_id)
            except BaseException:
                for p in pages:
                    self.pool.deref(p)
                raise
            if got is None:
                for p in pages:
                    self.pool.deref(p)
                return None
            aslot = got
        self._rid += 1
        now = time.perf_counter()
        req = Request(rid=self._rid, prompt=prompt,
                      max_new_tokens=int(max_new_tokens),
                      eos_id=(self.eos_id_default if eos_id is None
                              else int(eos_id)),
                      submit_t=now)
        req.admit_t = now
        req.adapter_id = adapter_id
        try:
            with self._span("serve/page_in", rid=req.rid, pages=need):
                self._import_pages(pages, page_payloads)
        except BaseException:
            for p in pages:
                self.pool.deref(p)
            if aslot:
                self.adapters.release(adapter_id)
            raise
        slot = self.scheduler.admit(req, now=now)
        req.pages = list(pages)
        req.shared_len = 0
        req.computed_len = len(prompt)
        req.kv_len = len(prompt)
        self._set_table_row(slot, pages)
        self._bind_adapter(req, slot, aslot)
        self.cache["lengths"][slot] = len(prompt)
        if self.spec_k:
            # the draft has no imported pages — mirror the prompt into
            # its slot cache the ordinary way (draft prefill is cheap)
            self._draft_prefill(req, slot=slot)
        # the first token was generated (and latency-counted) on the
        # prefill replica; record it here without double-counting
        req.tokens.append(int(first_token))
        req.token_times.append(0.0)
        req.last_token = int(first_token)
        req.last_t = now
        reason = self.scheduler.finish_reason(req, int(first_token),
                                              self.max_seq_len)
        if reason is not None:
            self._finish(slot, reason)
        return req

    def _export_pages(self, pages: List[int]) -> List[bytes]:
        """Pool pages ``pages`` as one payload each: the page's leaf
        slices (``[:, pid]``) concatenated in ``_page_leaves`` order, one
        gather and one device-to-host copy per leaf.  Under a mesh each
        page is gathered whole: its heads over ``model``, then its owner's
        copy over ``data`` (every rank gets the same bytes)."""
        n = len(pages)
        idx = torch.from_numpy(self._local_pages(
            np.asarray(pages, np.int64))).to(self.device)
        leaves = []
        for k in self._page_leaves():
            # [L, n, ...] -> [n, L, ...]: page i's slice of a leaf is then
            # one contiguous run of bytes, laid out as cache[k][:, pid]
            x = self.cache[k].index_select(1, idx).transpose(0, 1)
            x = x.contiguous().view(torch.uint8)
            if self.mesh is not None:
                x = col.all_gather(x, self.mesh, MODEL_AXIS, 2)
                x = col.all_gather(x[None], self.mesh, DATA_AXIS)
                owner = [self.pool.part_of(p) for p in pages]
                x = x[owner, list(range(n))]
            leaves.append(x.cpu().numpy().reshape(n, -1))
        return [b"".join(leaf[i].tobytes() for leaf in leaves)
                for i in range(n)]

    def _import_pages(self, pages: List[int],
                      payloads: List[bytes]) -> None:
        """Payloads of ``_export_pages``' layout into pool pages
        ``pages``: one host-to-device copy and one scatter per leaf."""
        n = len(pages)
        raw = np.frombuffer(bytearray(b"".join(payloads)),
                            np.uint8).reshape(n, -1)
        # under a mesh a rank writes its heads of the pages it holds
        mine = [i for i, p in enumerate(pages)
                if self.pool.part_of(p) == self._dr]
        if not mine:
            return
        idx = torch.from_numpy(self._local_pages(
            np.asarray(pages, np.int64)[mine])).to(self.device)
        off = 0
        for k, nb in zip(self._page_leaves(), self.page_leaf_nbytes()):
            ref = self.cache[k]
            shape = ((n, ref.shape[0], ref.shape[2] * self._tp)
                     + tuple(ref.shape[3:]))
            part = torch.from_numpy(np.ascontiguousarray(
                raw[mine, off:off + nb])).view(ref.dtype)
            src = part.view((len(mine),) + shape[1:])
            if self.mesh is not None:
                src = RankSharding(self.mesh, (None, None, MODEL_AXIS)
                                   ).piece(src)
            ref.index_copy_(1, idx, src.to(self.device).transpose(0, 1))
            off += nb

    # -- admission (prefill) ----------------------------------------------
    def _prefill(self, tokens: torch.Tensor, length: int, slot: int) -> int:
        """Prefill one padded prompt into ``slot``: ALL ``prefill_len``
        rows are written (the padded tail is garbage the length masks
        out), then the first token is read back.  Under a mesh the slot's
        data rank computes it and broadcasts the logits row."""
        owner = self._owner(slot)
        if owner == self._dr:
            logits, ks, vs = self.model.prefill(self.params, tokens,
                                                **self._mkw)
            rows = tokens.shape[1]
            self.cache["k"][:, slot - self._s0, :, :rows] = ks[:, 0]
            self.cache["v"][:, slot - self._s0, :, :rows] = vs[:, 0]
            row = logits[0, length - 1]
        else:
            row = self._empty_row()
        self.cache["lengths"][slot] = length
        return int(self._select(self._from_owner(row, owner)))

    def _empty_row(self) -> torch.Tensor:
        return torch.empty((self.model.config.vocab_size,),
                           dtype=self._logits_dtype, device=self.device)

    def _scales(self) -> Dict[str, torch.Tensor]:
        """The int8 pool's scale sidecars as keyword arguments of the
        model's paged functions (none on the fp pool)."""
        if not self.quant_kv:
            return {}
        return {"k_scale": self.cache["k_scale"],
                "v_scale": self.cache["v_scale"]}

    def _prefill_paged(self, tokens: np.ndarray, delta_len: int,
                       prefix_len: int, row: np.ndarray, slot: int,
                       aslot: int = 0) -> int:
        """One delta-aware prefill (or chunk) into ``slot``'s pages, with
        the tenant's adapter in pool slot ``aslot`` (lora only), then the
        next token after its last computed position (computed by the
        slot's data rank under a mesh, its logits row broadcast)."""
        owner = self._owner(slot)
        if owner == self._dr:
            logits = self.model.prefill_paged(
                self.params, torch.from_numpy(tokens).to(self.device),
                delta_len, prefix_len,
                torch.from_numpy(self._local_pages(row)).to(self.device),
                self.cache["k"], self.cache["v"], **self._scales(),
                **self._lora_kw(aslot), **self._mkw)[0]
            row = logits[0, delta_len - 1]
        else:
            row = self._empty_row()
        self.cache["lengths"][slot] = prefix_len + delta_len
        return int(self._select(self._from_owner(row, owner)))

    def _admit_one(self, req: Request) -> bool:
        """Admit one request (prefill + slot assignment).  Returns False
        when the paged pool can't hold it yet (backpressure — the request
        stays parked); True otherwise."""
        if self.paged:
            return self._admit_one_paged(req)
        return self._admit_one_slot(req)

    def _alloc_pages(self, n: int, part: int = 0) -> Optional[List[int]]:
        """``n`` fresh pages of range ``part``, evicting least-recently-hit
        prefix-cache leaves under pressure; None when the range is dry
        even after eviction (reference ``engine.py:1278-1286``)."""
        pages = self.pool.alloc(n, part)
        if pages is None and self.prefix is not None:
            if self.prefix.evict(n, part):
                pages = self.pool.alloc(n, part)
        return pages

    def _copy_page(self, src: int, dst: int) -> None:
        """Copy-on-write: duplicate one page of every layer's K and V and,
        on the int8 pool, their scale sidecars (else the copy would
        dequantize with the wrong scales)."""
        if self.pool.part_of(src) != self._dr:
            return          # another data rank's pages
        ls, ld = (int(p) for p in self._local_pages([src, dst]))
        with self._span("serve/page_cow", src=src, dst=dst):
            for key in ("k", "v", "k_scale", "v_scale"):
                if key in self.cache:
                    self.cache[key][:, ld] = self.cache[key][:, ls]

    def _draft_prefill(self, req: Request,
                       slot: Optional[int] = None) -> None:
        """Mirror the admitted prompt into the draft's slot cache so the
        next tick's proposals start from the history the target holds.
        The logits are discarded: the tick's first pending token is the
        target's.  ``slot`` overrides the next-free-slot peek for a
        request already admitted (chunked prefill's final chunk)."""
        tokens = np.zeros((1, self.prefill_len), np.int64)
        tokens[0, :len(req.prompt)] = req.prompt
        slot = self.scheduler.free[0] if slot is None else slot
        dc = self._draft_cache
        dc["lengths"][slot] = len(req.prompt)
        if self._owner(slot) != self._dr:
            return          # another data rank's slot
        with self._span("serve/draft_prefill", rid=req.rid):
            _, ks, vs = self.draft_model.prefill(
                self.draft_params, torch.from_numpy(tokens).to(self.device),
                **self._mkw)
            dc["k"][:, slot - self._s0, :, :self.prefill_len] = ks[:, 0]
            dc["v"][:, slot - self._s0, :, :self.prefill_len] = vs[:, 0]

    def _admit_one_paged(self, req: Request) -> bool:
        """Reference ``_admit_one_paged`` (``engine.py:1329-1505``): match
        the prefix in the tenant's namespace, extend the match with the KV
        tier's parked pages, allocate the rest, pin the tenant's adapter
        slot, COW a shared partial tail, then prefill the delta (or admit
        it for chunked prefill).  A dry page pool or adapter pool parks the
        request (False) with nothing held."""
        total_pages = -(-len(req.prompt) // self.page_len)
        # tenant namespace: tenant A's KV pages are never matched by
        # tenant B (or the base model); "" is the no-lora digest chain.
        # Under a data split, a slot's pages (shared ones too) come from
        # its rank's range only
        part = self._part(self.scheduler.free[0])
        ns = self._namespace(req, part)
        if self.prefix is not None:
            shared_len, spages, cow = self.prefix.match(req.prompt, ns)
        else:
            shared_len, spages, cow = 0, [], False
        tpages: List[int] = []
        if self.kv_tier is not None and not cow \
                and shared_len % self.page_len == 0 \
                and self.pool.free_count >= total_pages - len(spages):
            # session resume: continue the digest chain into the parked
            # tier — fetched pages extend the match and insert() below
            # re-registers them, so a resume IS a prefix hit.  Gated on
            # enough free pages for the whole admission so one-shot
            # records are not spent on a request that then parks; tier
            # failures fall back to the delta prefill below
            shared_len, tpages = self.kv_tier.resume(
                req.prompt, ns, shared_len,
                lambda n: self._alloc_pages(n, part))
        fresh = self._alloc_pages(total_pages - len(spages) - len(tpages)
                                  + (1 if cow else 0), part)
        if fresh is None:
            if self.prefix is not None:
                self.prefix.release(spages)
            for p in tpages:
                self.pool.deref(p)
            return False
        held = list(spages) + tpages + fresh
        aslot = 0
        if self.lora and req.adapter_id:
            # tenant -> pool slot AFTER the page alloc, so a pages-dry
            # park never holds an adapter pin; a dry adapter pool parks
            # the request like a pages-dry admission
            try:
                got = self.adapters.acquire(req.adapter_id)
            except BaseException:
                for p in held:
                    self.pool.deref(p)
                raise
            if got is None:
                for p in held:
                    self.pool.deref(p)
                return False
            aslot = got
        try:
            # queue wait ends here, before any device work
            req.admit_t = time.perf_counter()
            self._end_queue_wait(req)
            fi = 0
            if cow:
                # divergent append into a shared partial page: copy it
                # into a fresh page BEFORE the delta prefill writes its
                # remaining rows
                self._copy_page(spages[-1], fresh[0])
                self.pool.deref(spages[-1])
                held.remove(spages[-1])
                row = spages[:-1] + fresh[:1]
                fi = 1
            else:
                row = list(spages) + tpages
            row.extend(fresh[fi:])
            delta = req.prompt[shared_len:]
            if self.prefill_chunk_len \
                    and len(delta) > self.prefill_chunk_len:
                # chunked prefill: admit the slot now with no device
                # work; step() feeds the delta one chunk per tick.
                # prefix.insert waits for the final chunk: a half-written
                # page must never be matched by a concurrent sharer
                slot = self.scheduler.admit(req, now=time.perf_counter())
                self._note_prefix(shared_len, cow)
                req.pages = row
                req.shared_len = shared_len
                req.computed_len = len(delta)
                req.kv_len = shared_len
                req.prefilling = True
                req.chunk_pos = 0
                self._set_table_row(slot, row)
                self._bind_adapter(req, slot, aslot)
                return True
            tokens = np.zeros((1, self.prefill_len), np.int64)
            tokens[0, :len(delta)] = delta
            row_np = np.zeros((self.max_pages,), np.int32)
            row_np[:len(row)] = row
            with self._span("serve/prefill", rid=req.rid,
                            prompt_len=len(req.prompt),
                            computed=len(delta), shared=shared_len):
                self._flow("start", req)
                first = self._prefill_paged(tokens, len(delta), shared_len,
                                            row_np, self.scheduler.free[0],
                                            aslot)
            if self.spec_k:
                # the draft mirrors the FULL prompt (it has no prefix cache)
                self._draft_prefill(req)
        except BaseException:
            # roll back every page (and the adapter pin) this admission
            # still holds
            for p in held:
                self.pool.deref(p)
            if aslot:
                self.adapters.release(req.adapter_id)
            raise
        now = time.perf_counter()
        req.prefill_s = now - req.admit_t
        slot = self.scheduler.admit(req, now=now)
        self._note_prefix(shared_len, cow)
        req.pages = row
        req.shared_len = shared_len
        req.computed_len = len(delta)
        self._set_table_row(slot, row)
        self._bind_adapter(req, slot, aslot)
        if self.prefix is not None:
            # register the freshly computed pages for future sharers
            self.prefix.insert(req.prompt, row, ns)
        req.kv_len = len(req.prompt)
        self._first_token(req, slot, first, now)
        return True

    def _namespace(self, req: Request, part: int) -> str:
        """The prefix-cache namespace of ``req``'s tenant on page range
        ``part`` (one range: the tenant's alone)."""
        ns = f"adapter:{req.adapter_id}" if req.adapter_id else ""
        return ns if self._dp == 1 else f"{ns}|part:{part}"

    def _bind_adapter(self, req: Request, slot: int, aslot: int) -> None:
        if self.lora:
            req.adapter_slot = aslot
            self._adapter_table[slot] = aslot

    def _release_adapter(self, req: Request, slot: int) -> None:
        """Unpin the tenant's adapter (refcount 0 keeps it resident and
        evictable) and point the dead slot at the zero adapter."""
        if self.lora and req.adapter_id:
            self.adapters.release(req.adapter_id)
            self._adapter_table[slot] = 0
            req.adapter_slot = 0

    def _note_prefix(self, shared_len: int, cow: bool) -> None:
        """Prefix-cache stats count successful admissions only."""
        if self.prefix is not None:
            self.prefix.note_admission(shared_len)
            if cow:
                self.prefix.cow += 1
            if self.telemetry is not None:
                (self._prefix_hits if shared_len
                 else self._prefix_misses).inc()

    def _set_table_row(self, slot: int, row: List[int]) -> None:
        self._table[slot, :] = 0
        self._table[slot, :len(row)] = row

    def _first_token(self, req: Request, slot: int, first: int,
                     now: float) -> None:
        """Record the prefill's token (TTFT) and finish if it ends the
        request."""
        req.tokens.append(first)
        req.token_times.append(now - req.submit_t)
        req.last_token = first
        self._count_token(now - req.submit_t)
        if self.telemetry is not None:
            self._ttft_hist.observe(now - req.submit_t)
        reason = self.scheduler.finish_reason(req, first, self.max_seq_len)
        if reason is not None:
            self._finish(slot, reason)

    def _admit_one_slot(self, req: Request) -> bool:
        tokens = np.zeros((1, self.prefill_len), np.int64)
        tokens[0, :len(req.prompt)] = req.prompt
        req.admit_t = time.perf_counter()
        self._end_queue_wait(req)
        with self._span("serve/prefill", rid=req.rid,
                        prompt_len=len(req.prompt)):
            self._flow("start", req)
            first = self._prefill(torch.from_numpy(tokens).to(self.device),
                                  len(req.prompt), self.scheduler.free[0])
        if self.spec_k:
            self._draft_prefill(req)
        now = time.perf_counter()
        req.prefill_s = now - req.admit_t
        slot = self.scheduler.admit(req, now=now)
        req.kv_len = len(req.prompt)
        self._first_token(req, slot, first, now)
        return True

    def _admit(self) -> None:
        while self.scheduler.has_free():
            if self._pending:
                req = self._pending[0]
            else:
                req = self._pop_request()
                if req is None:
                    return
                self._pending.append(req)
            try:
                ok = self.stage.call(
                    "admit", lambda r=req: self._admit_one(r),
                    path=f"rid={req.rid}")
                if not ok:
                    # page-pool backpressure: the head request stays
                    # parked until eviction/release frees pages
                    return
                self._pending.popleft()
            except BaseException as e:
                self._pending.popleft()
                self._fail_request(req, e)
                if not isinstance(e, Exception):
                    # KeyboardInterrupt / SystemExit are not a
                    # per-request failure: poison and propagate
                    self._poison(e)
                    raise
                # one bad request must not take the pool down: the cache
                # is updated in place and the slot was never admitted, so
                # its rows stay masked — record the error, keep serving
                logger.error("serve: admission of rid=%d failed: %r",
                             req.rid, e)

    def _release_pages(self, req: Request) -> None:
        if req.pages:
            for p in req.pages:
                self.pool.deref(p)
        req.pages = None

    def _finish(self, slot: int, reason: str) -> None:
        req = self.scheduler.release(slot, reason)
        if self.paged:
            # eviction = page frees + a zeroed (scratch) table row — except
            # a KV-migration source (detach_kv), whose pages stay held for
            # export_pages; release_detached frees them after the transfer
            self._table[slot, :] = 0
            if not req.detach_kv:
                self._release_pages(req)
        self._release_adapter(req, slot)
        # record + trace close BEFORE done.set(): a waiter released by
        # result() finds the artifacts already written
        self._write_request_record(req)
        self._end_request_trace(req, reason=reason)
        req.done.set()
        if self.telemetry is not None:
            self._requests_total.inc()

    # -- chunked prefill --------------------------------------------------
    def _prefill_chunk_tick(self) -> int:
        """One chunk of the OLDEST mid-prefill slot (reference
        ``engine.py:1636-1704``): the delta-aware prefill with
        ``prefix_len`` advanced to the chunk boundary.  The FINAL chunk's
        next token is the request's first token.  Returns tokens produced
        (0 until the final chunk)."""
        req = next((r for r in self.scheduler.active.values()
                    if r.prefilling), None)
        if req is None:
            return 0
        slot = req.slot
        delta = req.prompt[req.shared_len:]
        pos = req.chunk_pos
        chunk = delta[pos:pos + self.prefill_chunk_len]
        final = pos + len(chunk) >= len(delta)
        tokens = np.zeros((1, self.prefill_len), np.int64)
        tokens[0, :len(chunk)] = chunk
        with self._span("serve/prefill_chunk", rid=req.rid, pos=pos,
                        chunk=len(chunk)):
            if final:
                self._flow("start", req)
            first = self._prefill_paged(tokens, len(chunk),
                                        req.shared_len + pos,
                                        self._table[slot], slot,
                                        req.adapter_slot if self.lora else 0)
        req.chunk_pos = pos + len(chunk)
        req.kv_len = req.shared_len + req.chunk_pos
        if not final:
            return 0
        now = time.perf_counter()
        req.prefilling = False
        req.prefill_s = now - req.admit_t
        req.kv_len = len(req.prompt)
        if self.prefix is not None:
            # the pages are fully written now: register them under the
            # namespace the admission matched with
            self.prefix.insert(req.prompt, req.pages,
                               self._namespace(req, self._part(slot)))
        if self.spec_k:
            self._draft_prefill(req, slot=slot)
        req.last_t = now
        self._first_token(req, slot, first, now)
        return 1

    # -- the decode tick --------------------------------------------------
    def _decoding(self) -> Dict[int, Request]:
        """Active slots past their prefill: mid-prefill slots ride masked
        (they have no last token and their KV is a partial prefix)."""
        return {s: r for s, r in self.scheduler.active.items()
                if not r.prefilling}

    def _grow_pages(self, active_map: Dict[int, Request], rows: int) -> None:
        """Allocate, BEFORE the pass, the pages covering each slot's next
        ``rows`` positions (capped at max_seq_len); a pool dry even after
        prefix-cache eviction finishes the request with ``kv_capacity``
        (reference ``engine.py:1712-1726, 1791-1808``)."""
        for slot, req in list(active_map.items()):
            need = -(-min(req.kv_len + rows, self.max_seq_len)
                     // self.page_len)
            extra = need - len(req.pages)
            if extra <= 0:
                continue
            pg = self._alloc_pages(extra, self._part(slot))
            if pg is None:
                self._finish(slot, "kv_capacity")
                del active_map[slot]
                continue
            for p in pg:
                self._table[slot, len(req.pages)] = p
                req.pages.append(p)

    def _batch(self, active_map: Dict[int, Request]):
        """(last tokens [S], active [S]) on the device."""
        tokens = np.zeros((self.slots,), np.int64)
        active = np.zeros((self.slots,), bool)
        for slot, req in active_map.items():
            tokens[slot] = req.last_token
            active[slot] = True
        return (torch.from_numpy(tokens).to(self.device),
                torch.from_numpy(active).to(self.device))

    def _decode_tick(self) -> int:
        active_map = self._decoding()
        if self.paged:
            self._grow_pages(active_map, 1)
        if not active_map:
            return 0
        tokens, active = self._batch(active_map)
        with self._span("serve/decode_step", active=len(active_map)):
            # per-tick decode attribution: each active request's flow
            # steps through this tick's span (host appends only)
            for req in active_map.values():
                self._flow("step", req, tick=self._ticks)
            args = (self.params, self._rows(tokens), self.cache["k"],
                    self.cache["v"])
            if self.paged:
                logits = self.model.decode_step_paged(
                    *args, self._table_dev(),
                    self._rows(self.cache["lengths"]), self._rows(active),
                    impl=self.decode_impl, **self._scales(),
                    **self._lora_kw(self._adapter_slots()), **self._mkw)[0]
            else:
                logits = self.model.decode_step(
                    *args, self._rows(self.cache["lengths"]),
                    self._rows(active), impl=self.decode_impl,
                    **self._mkw)[0]
            self.cache["lengths"] = (self.cache["lengths"]
                                     + active.to(torch.int32))
            self.decode_ticks += 1
            # the per-token latency point: the pull is the device sync
            next_host = self._select(self._all_slots(logits)).cpu().numpy()
        now = time.perf_counter()
        produced = 0
        for slot, req in active_map.items():
            tok = int(next_host[slot])
            req.kv_len += 1
            req.tokens.append(tok)
            req.token_times.append(now - req.last_t)
            self._count_token(now - req.last_t)
            self._tpot_lat.append(now - req.last_t)
            req.last_t = now
            req.last_token = tok
            produced += 1
            reason = self.scheduler.finish_reason(req, tok,
                                                  self.max_seq_len)
            if reason is not None:
                self._finish(slot, reason)
        return produced

    def _propose(self, tokens: torch.Tensor, active: torch.Tensor,
                 seed: Optional[int] = None):
        """k+1 chained draft decode steps (reference ``propose_fn``,
        ``engine.py:832-853``); returns the k proposals [S, k] int32 on the
        device and, sampling, the distributions they were drawn from,
        ``softmax(logits / T)`` [S, k, V] fp32 (else None).  Step ``i``
        samples with a generator of ``fold_in(seed, i)``.  The extra step
        writes the last proposal's K/V, so a fully accepted block leaves
        the draft cache aligned with the target's."""
        dc = self._draft_cache
        props, qs = [], []
        tok = tokens
        T = self.temperature
        for i in range(self.spec_k + 1):
            logits = self.draft_model.decode_step(
                self.draft_params, self._rows(tok), dc["k"], dc["v"],
                self._rows(dc["lengths"]), self._rows(active),
                impl=self._draft_impl, **self._mkw)[0]
            dc["lengths"] = dc["lengths"] + active.to(torch.int32)
            lg = self._all_slots(logits).float()
            if seed is None:
                tok = select_next_token(lg)
            else:
                tok = select_next_token(
                    lg, T, self._generator(fold_in(seed, i)))
                if i < self.spec_k:
                    qs.append(torch.softmax(lg / T, dim=-1))
            if i < self.spec_k:
                props.append(tok)
        return (torch.stack(props, dim=1),
                torch.stack(qs, dim=1) if qs else None)

    def _verify(self, tokens: torch.Tensor, proposals: torch.Tensor,
                active: torch.Tensor, qprobs: Optional[torch.Tensor] = None,
                rng: Optional[torch.Generator] = None) -> np.ndarray:
        """The widened target pass + acceptance (greedy, or rejection
        sampling against the draft's ``qprobs`` with ``rng``) + the masked
        lengths advance, all on the device; one read-back of ``[S, W+1]``:
        each slot's W emitted-token candidates then its accepted count."""
        tokens_w = torch.cat([tokens[:, None].to(torch.int32),
                              proposals.to(torch.int32)], dim=1)
        args = (self.params, self._rows(tokens_w), self.cache["k"],
                self.cache["v"])
        if self.paged:
            logits = self.model.verify_step_paged(
                *args, self._table_dev(), self._rows(self.cache["lengths"]),
                self._rows(active), impl=self.decode_impl,
                **self._scales(), **self._lora_kw(self._adapter_slots()),
                **self._mkw)[0]
        else:
            logits = self.model.verify_step(
                *args, self._rows(self.cache["lengths"]),
                self._rows(active), impl=self.decode_impl, **self._mkw)[0]
        out_tok, accepted = speculative_accept(
            self._all_slots(logits).float(), proposals, qprobs,
            self.temperature, rng)
        adv = torch.where(active, accepted + 1, 0).to(torch.int32)
        self.cache["lengths"] = torch.clamp(
            self.cache["lengths"] + adv, max=self.max_seq_len)
        self.verify_ticks += 1
        return torch.cat([out_tok, accepted[:, None]], dim=1).cpu().numpy()

    def _spec_tick(self) -> int:
        """One speculative serving tick (reference ``_spec_tick``,
        ``engine.py:1778-1922``): the draft proposes k tokens per active
        slot, the target scores all k+1 positions per slot in one verify
        pass, and each request advances by its accepted prefix plus the
        bonus token.  Rollback masks lengths back (slot cache) or frees
        the speculated pages (paged)."""
        W = self.spec_k + 1
        active_map = self._decoding()
        if self.paged:
            # the whole speculative block's pages, up front
            self._grow_pages(active_map, W)
        if not active_map:
            return 0
        tokens, active = self._batch(active_map)
        with self._span("serve/draft_propose", active=len(active_map),
                        k=self.spec_k):
            proposals, qprobs = self._propose(tokens, active,
                                              self._next_seed())
        with self._span("serve/verify_step", active=len(active_map),
                        k=self.spec_k):
            for req in active_map.values():
                self._flow("step", req, tick=self._ticks)
            # the per-block latency point: the read-back is the sync
            host = self._verify(tokens, proposals, active, qprobs,
                                self._generator(self._next_seed()))
        now = time.perf_counter()
        produced = 0
        for slot, req in active_map.items():
            m = int(host[slot, W])
            emit = [int(t) for t in host[slot, :m + 1]]
            finished = False
            used = 0
            for tok in emit:
                # the block lands at one wall moment: the first token
                # carries the pass latency, the rest arrive "free"
                req.kv_len += 1
                req.tokens.append(tok)
                lat = (now - req.last_t) if used == 0 else 0.0
                req.token_times.append(lat)
                self._count_token(lat)
                self._tpot_lat.append(lat)
                produced += 1
                used += 1
                reason = self.scheduler.finish_reason(
                    req, tok, self.max_seq_len)
                if reason is not None:
                    # EOS / budget / capacity inside the accepted block:
                    # the tail is discarded, _finish releases every page
                    # incl. the speculative pre-allocation
                    self._finish(slot, reason)
                    finished = True
                    break
            # accounting counts the tokens the pass DELIVERED
            req.spec_accepted.append(used - 1)
            self._spec_passes += 1
            self._spec_proposed_n += self.spec_k
            self._spec_accepted_n += used - 1
            if self.telemetry is not None:
                self._spec_proposed.inc(self.spec_k)
                self._spec_accepted_ctr.inc(used - 1)
                self._spec_len_hist.observe(used)
            if finished:
                continue
            req.last_t = now
            req.last_token = emit[-1]
            if self.paged:
                # keep the pages covering the verified rows, free the ones
                # only rejected speculation touched
                keep = -(-req.kv_len // self.page_len)
                while len(req.pages) > keep:
                    pg = req.pages.pop()
                    self._table[slot, len(req.pages)] = 0
                    self.pool.deref(pg)
        # draft rollback: one lengths row masks every live slot's draft
        # KV back to its verified length
        dlen = np.zeros((self.slots,), np.int32)
        for slot, req in self.scheduler.active.items():
            dlen[slot] = req.kv_len
        self._draft_cache["lengths"] = torch.from_numpy(dlen).to(
            self.device)
        return produced

    def step(self) -> int:
        """One serving tick: admit into free slots, then (chunked prefill)
        one prefill chunk, then one masked decode — or, speculating, one
        draft-propose + verify block — over the whole pool.  Returns
        tokens produced."""
        if self._closed:
            raise RuntimeError("ServeEngine is closed")
        if self.kv_tier is not None:
            # park BEFORE admission so pages freed by parking are
            # allocatable this very tick
            self.kv_tier.park_tick(self._ticks)
        self._admit()
        try:
            n = 0
            if self.prefill_chunk_len and any(
                    r.prefilling for r in self.scheduler.active.values()):
                n += self.stage.call("prefill_chunk",
                                     self._prefill_chunk_tick)
            n += self.stage.call(
                "step",
                self._spec_tick if self.spec_k else self._decode_tick)
        except BaseException as e:
            self._poison(e)
            raise
        if self.telemetry is not None:
            self._active_gauge.set(len(self.scheduler.active))
            if self.paged:
                self._free_pages_gauge.set(self.pool.free_count)
        self._ticks += 1
        if self._ticks % self._flush_every == 0:
            self._flush()
        return n

    def run_until_idle(self, max_ticks: int = 100_000) -> int:
        """Serve until the queue and every slot are empty.  Returns total
        tokens produced."""
        total = 0
        for _ in range(max_ticks):
            if not self.scheduler.active and not self._pending \
                    and self.queue.qsize() == 0:
                return total
            total += self.step()
        raise RuntimeError(
            f"serve loop still busy after max_ticks={max_ticks} "
            f"({len(self.scheduler.active)} active, "
            f"{len(self._pending)} pending, "
            f"{self.queue.qsize()} queued)")

    # -- the KV tier's page seams -----------------------------------------
    def _page_leaves(self) -> List[str]:
        """Pool-shaped cache leaves in the payload's fixed order (the
        scale sidecars ride along on the int8 pool)."""
        return [k for k in ("k", "v", "k_scale", "v_scale")
                if k in self.cache]

    def _export_page_bytes(self, pid: int) -> bytes:
        """ONE pool page as raw host bytes, each leaf's ``[:, pid]`` slice
        in ``_page_leaves`` order — the KV tier's spill unit (it CRC-
        stamps the bytes before the page's pool ref is released)."""
        with self._span("serve/kv_spill", page=pid):
            return self._export_pages([pid])[0]

    def _import_page_bytes(self, pid: int, payload: bytes) -> None:
        """Import one parked page payload into pool page ``pid`` — the KV
        tier's fetch unit.  A payload of another size than this pool's
        page is a corrupt record, raised typed before any byte lands."""
        page_nb = sum(self.page_leaf_nbytes())
        if len(payload) != page_nb:
            raise KVTierCorruptError(
                f"parked page payload is {len(payload)} bytes; this "
                f"pool's page is {page_nb}")
        with self._span("serve/kv_fetch", page=pid):
            self._import_pages([pid], [payload])

    def _drain_kv_spill(self):
        """Write every host-resident parked page to the disk tier (when
        one exists) — the spill plane's drain barrier."""
        if self.kv_tier is not None:
            self.kv_tier.drain()

    def _close_kv_spill(self):
        if self.kv_tier is not None:
            self.kv_tier.close_spill()

    def _close_kv_fetch(self):
        if self.kv_tier is not None:
            self.kv_tier.close()

    # -- failure + shutdown ----------------------------------------------
    def _fail_request(self, req: Request, err: BaseException) -> None:
        """The one per-request failure path: record + trace close before
        done.set()."""
        req.error = err
        self._write_request_record(req)
        self._end_request_trace(req, error=err)
        req.done.set()
        if self.telemetry is not None:
            self._requests_failed.inc()

    def _poison(self, err: BaseException) -> None:
        """A failed decode tick is fatal for every in-flight request (the
        cache may hold a half-written tick).  Typed propagation —
        requests and submitters see the ORIGINAL exception; every
        in-flight trace ends in an error span and the flight recorder
        dumps."""
        self.queue.poison(err)
        self.stage.record_event("poison", error=repr(err))
        for slot in list(self.scheduler.active):
            req = self.scheduler.release(slot, "error")
            if self.paged:
                self._table[slot, :] = 0
                self._release_pages(req)
            self._release_adapter(req, slot)
            self._fail_request(req, err)
        while self._pending:
            self._fail_request(self._pending.popleft(), err)
        self.dump_flight_record(reason="serve poison", error=err)

    def _close_queue(self):
        err = RuntimeError("ServeEngine closed")
        # mark closed and capture the backlog under ONE lock hold: a
        # submit() racing close() either sees put() return False or its
        # item lands in `items` here and fails typed
        with self.queue.cond:
            self.queue.closed = True
            items = list(self.queue.items)
            self.queue.items.clear()
            self.queue.cond.notify_all()
        items = list(self._pending) + items
        self._pending.clear()
        for req in items:
            self._fail_request(req, err)
        if self.prefix is not None:
            self.prefix.clear()

    def _close_telemetry(self):
        if self.telemetry is not None:
            self._flush()
            self.telemetry.close()

    def close(self):
        """Idempotent: drain order is queue -> kv spill -> kv fetch ->
        telemetry (docs/serving.md); queued never-admitted requests fail
        with a typed error instead of hanging their waiters."""
        if self._closed:
            return
        self._closed = True
        errors = self._graph.close_all()
        if errors:
            raise errors[0][1]
