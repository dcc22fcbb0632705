"""ServeEngine — the KV-cached greedy decode engine (docs/serving.md),
ported to PyTorch: the slot cache, the paged pool with prefix caching and
chunked prefill, and greedy speculative decoding on both layouts.

Requests stream through a bounded queue into a FIXED pool of decode
slots, and two steps serve every mix:

  prefill      one request's prompt (right-padded to the static
               ``serving.prefill_len`` bucket) → its K/V rows written
               into the assigned slot (or its pages) + the first greedy
               token.  Runs the flash-attention forward kernel on
               ``attn_impl="flash"``.
  decode tick  ONE masked tick for ALL slots at once: each active slot's
               last token in, its next greedy token out, its K/V appended
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

Quantized serving (``serving.quantization``, reference ``engine.py:
182-210, 387-447, 595-607``): ``weights: "int8"`` quantizes the target's
(and the draft's) matmul weights once at build (``inference/quantize.py``)
on either layout; ``kv: "int8"`` (paged only) stores the pool as int8 rows
with fp32 scale sidecars that every prefill, decode tick, verify pass and
copy-on-write carries.  ``param_bytes`` and ``kv_bytes`` are the device
bytes the parameters and the KV caches claim, as the JAX engine counts
them.

Fault plane: the request queue is a stages :class:`Channel` and all
serving work runs under one :class:`Stage` record ("serve", points
``admit``/``prefill_chunk``/``step``), so poison/drain semantics,
graceful degradation and the ``DS_STAGE_FAULT``/``DS_STAGE_DELAY_S``
spec apply as in the JAX engine.

The engine runs on ``cuda:0`` unless the caller passes ``device``; with no
CUDA device and no ``device`` it raises.  Config that this port does not
cover yet raises ``NotImplementedError`` naming its ROADMAP.md item —
nothing is silently ignored.
"""
from __future__ import annotations

import contextlib
import json
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
from ..runtime.engine_stages import wire_serve_stage_plane
from ..runtime.stages import Channel, Stage
from ..utils.logging import logger
from .kv_cache import (KVCacheSpec, PagedKVCacheSpec, init_cache,
                       init_paged_cache)
from .quantize import param_nbytes, quantize_gpt2_params
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


def _unported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to deepspeed_tpu_torch yet: ROADMAP.md "
        f"queue 1, {item}")


def _refuse_unported(cfg: _ServeConfigView) -> None:
    """Raise on every config knob whose path this port does not run yet."""
    sv = cfg.serving
    if sv.temperature > 0:
        raise _unported("serving.temperature > 0 (sampling)",
                        "item 7.3 (speculation and sampling)")
    if sv.lora[C.SERVING_LORA_RANK] > 0:
        raise _unported("serving.lora.rank > 0 (multi-tenant LoRA)",
                        "item 7.5 (LoRA adapters)")
    if sv.kv_tier[C.SERVING_KV_TIER_IDLE_PARK_TICKS] > 0:
        raise _unported("serving.kv_tier (KV tiering)",
                        "item 7.6 (KV tiering)")
    if cfg.telemetry.enabled:
        raise _unported("telemetry.enabled", "item 5 (telemetry)")


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


class ServeEngine:
    """Continuous-batching greedy decode over a GPT-2-family model.

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
        if mesh is not None:
            raise _unported("a mesh (data/tensor-parallel serving)",
                            "item 9 (data/tensor parallel)")
        self.device = _resolve_device(device)
        self.model = model
        cfg = _ServeConfigView(config)
        _refuse_unported(cfg)
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
            # the scratch page
            pages = cfg.serving.pages or 1 + self.slots * self.max_pages
            self.cache_spec = PagedKVCacheSpec(
                layers=mcfg.n_layer, slots=self.slots, heads=mcfg.n_head,
                pages=pages, page_len=self.page_len, head_dim=mcfg.d_head,
                max_pages=self.max_pages,
                dtype=torch.int8 if self.quant_kv else kv_dtype,
                quant=self.quant_kv)
            self.cache = init_paged_cache(self.cache_spec, self.device)
            self.pool = PagePool(pages)
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
            self.cache = init_cache(self.cache_spec, self.device)
        if self.spec_k:
            self._build_spec_plane(cfg, mcfg, draft_params, seed)

        # -- memory planes: the device bytes the params and KV caches
        # claim (reference engine.py:595-607)
        self.param_bytes = param_nbytes(self.params)
        self.kv_bytes = self.cache_spec.bytes
        if self.spec_k:
            self.param_bytes += param_nbytes(self.draft_params)
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
        wire_serve_stage_plane(self)

        self._rid = 0
        #: decode ticks that ran the model (each launches the decode
        #: kernel, slot or paged, once per layer)
        self.decode_ticks = 0
        #: speculative ticks that ran the verify pass (each launches the
        #: multi-query kernel once per target layer and the draft's decode
        #: kernel k+1 times per draft layer)
        self.verify_ticks = 0
        self._closed = False
        #: requests popped from the queue but not yet admitted — the
        #: page-pool backpressure parking spot (admission order kept)
        self._pending: deque = deque()

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
        self.draft_cache_spec = KVCacheSpec(
            layers=draft_cfg.n_layer, slots=self.slots,
            heads=draft_cfg.n_head, max_len=self.max_seq_len,
            head_dim=draft_cfg.d_head,
            dtype=self.draft_params["wte"].dtype)
        self._draft_cache = init_cache(self.draft_cache_spec, self.device)

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
        """No-op: telemetry is not ported yet (enabling it raises)."""
        return contextlib.nullcontext()

    # -- request intake ---------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 16,
               eos_id: Optional[int] = None,
               detach_kv: bool = False,
               adapter_id: int = 0) -> Request:
        """Enqueue one generation request (blocks on a full queue — the
        open-loop backpressure point).  Greedy decoding; the first
        generated token comes from the prefill logits.  ``detach_kv`` and
        ``adapter_id`` keep the JAX engine's surface: KV migration
        (the serving fleet) and LoRA are not ported, so both are
        refused."""
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
        if detach_kv:
            raise _unported("detach_kv (KV-page migration)",
                            "item 8 (serving fleet)")
        adapter_id = int(adapter_id)
        if adapter_id < 0:
            raise ValueError("adapter_id must be >= 0 (0 = base model)")
        if adapter_id > 0:
            raise ValueError(
                f"adapter_id={adapter_id} but multi-tenant LoRA is off "
                "(set serving.lora.rank > 0)")
        self._rid += 1
        req = Request(rid=self._rid, prompt=prompt,
                      max_new_tokens=int(max_new_tokens),
                      eos_id=(self.eos_id_default if eos_id is None
                              else int(eos_id)),
                      submit_t=time.perf_counter())
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

    # -- KV-page migration (the serving fleet) is not ported --------------
    def export_pages(self, req: Request):
        raise _unported("KV-page migration (export_pages)",
                        "item 8 (serving fleet)")

    def adopt_request(self, prompt, first_token: int, max_new_tokens: int,
                      eos_id: Optional[int], page_payloads,
                      adapter_id: int = 0):
        raise _unported("KV-page migration (adopt_request)",
                        "item 8 (serving fleet)")

    # -- admission (prefill) ----------------------------------------------
    def _prefill(self, tokens: torch.Tensor, length: int, slot: int) -> int:
        """Prefill one padded prompt into ``slot``: ALL ``prefill_len``
        rows are written (the padded tail is garbage the length masks
        out), then the first greedy token is read back."""
        logits, ks, vs = self.model.prefill(self.params, tokens)
        rows = tokens.shape[1]
        self.cache["k"][:, slot, :, :rows] = ks[:, 0]
        self.cache["v"][:, slot, :, :rows] = vs[:, 0]
        self.cache["lengths"][slot] = length
        return int(select_next_token(logits[0, length - 1]))

    def _scales(self) -> Dict[str, torch.Tensor]:
        """The int8 pool's scale sidecars as keyword arguments of the
        model's paged functions (none on the fp pool)."""
        if not self.quant_kv:
            return {}
        return {"k_scale": self.cache["k_scale"],
                "v_scale": self.cache["v_scale"]}

    def _prefill_paged(self, tokens: np.ndarray, delta_len: int,
                       prefix_len: int, row: np.ndarray, slot: int) -> int:
        """One delta-aware prefill (or chunk) into ``slot``'s pages, then
        the next greedy token after its last computed position."""
        logits = self.model.prefill_paged(
            self.params, torch.from_numpy(tokens).to(self.device), delta_len,
            prefix_len, torch.from_numpy(row).to(self.device),
            self.cache["k"], self.cache["v"], **self._scales())[0]
        self.cache["lengths"][slot] = prefix_len + delta_len
        return int(select_next_token(logits[0, delta_len - 1]))

    def _admit_one(self, req: Request) -> bool:
        """Admit one request (prefill + slot assignment).  Returns False
        when the paged pool can't hold it yet (backpressure — the request
        stays parked); True otherwise."""
        if self.paged:
            return self._admit_one_paged(req)
        return self._admit_one_slot(req)

    def _alloc_pages(self, n: int) -> Optional[List[int]]:
        """``n`` fresh pages, evicting least-recently-hit prefix-cache
        leaves under pressure; None when the pool is dry even after
        eviction (reference ``engine.py:1278-1286``)."""
        pages = self.pool.alloc(n)
        if pages is None and self.prefix is not None:
            if self.prefix.evict(n):
                pages = self.pool.alloc(n)
        return pages

    def _copy_page(self, src: int, dst: int) -> None:
        """Copy-on-write: duplicate one page of every layer's K and V and,
        on the int8 pool, their scale sidecars (else the copy would
        dequantize with the wrong scales)."""
        with self._span("serve/page_cow", src=src, dst=dst):
            for key in ("k", "v", "k_scale", "v_scale"):
                if key in self.cache:
                    self.cache[key][:, dst] = self.cache[key][:, src]

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
        with self._span("serve/draft_prefill", rid=req.rid):
            _, ks, vs = self.draft_model.prefill(
                self.draft_params, torch.from_numpy(tokens).to(self.device))
            dc = self._draft_cache
            dc["k"][:, slot, :, :self.prefill_len] = ks[:, 0]
            dc["v"][:, slot, :, :self.prefill_len] = vs[:, 0]
            dc["lengths"][slot] = len(req.prompt)

    def _admit_one_paged(self, req: Request) -> bool:
        """Reference ``_admit_one_paged`` (``engine.py:1329-1505``)
        without its KV-tier and LoRA branches: match the prefix, COW a
        shared partial tail, allocate the rest, then prefill the delta (or
        admit it for chunked prefill)."""
        total_pages = -(-len(req.prompt) // self.page_len)
        if self.prefix is not None:
            shared_len, spages, cow = self.prefix.match(req.prompt)
        else:
            shared_len, spages, cow = 0, [], False
        fresh = self._alloc_pages(total_pages - len(spages)
                                  + (1 if cow else 0))
        if fresh is None:
            if self.prefix is not None:
                self.prefix.release(spages)
            return False
        held = list(spages) + fresh
        try:
            req.admit_t = time.perf_counter()
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
                row = list(spages)
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
                return True
            tokens = np.zeros((1, self.prefill_len), np.int64)
            tokens[0, :len(delta)] = delta
            row_np = np.zeros((self.max_pages,), np.int32)
            row_np[:len(row)] = row
            with self._span("serve/prefill", rid=req.rid,
                            prompt_len=len(req.prompt),
                            computed=len(delta), shared=shared_len):
                first = self._prefill_paged(tokens, len(delta), shared_len,
                                            row_np, self.scheduler.free[0])
            if self.spec_k:
                # the draft mirrors the FULL prompt (it has no prefix cache)
                self._draft_prefill(req)
        except BaseException:
            # roll back every page this admission still holds a ref on
            for p in held:
                self.pool.deref(p)
            raise
        now = time.perf_counter()
        req.prefill_s = now - req.admit_t
        slot = self.scheduler.admit(req, now=now)
        self._note_prefix(shared_len, cow)
        req.pages = row
        req.shared_len = shared_len
        req.computed_len = len(delta)
        self._set_table_row(slot, row)
        if self.prefix is not None:
            # register the freshly computed pages for future sharers
            self.prefix.insert(req.prompt, row)
        req.kv_len = len(req.prompt)
        self._first_token(req, slot, first, now)
        return True

    def _note_prefix(self, shared_len: int, cow: bool) -> None:
        """Prefix-cache stats count successful admissions only."""
        if self.prefix is not None:
            self.prefix.note_admission(shared_len)
            if cow:
                self.prefix.cow += 1

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
        reason = self.scheduler.finish_reason(req, first, self.max_seq_len)
        if reason is not None:
            self._finish(slot, reason)

    def _admit_one_slot(self, req: Request) -> bool:
        tokens = np.zeros((1, self.prefill_len), np.int64)
        tokens[0, :len(req.prompt)] = req.prompt
        req.admit_t = time.perf_counter()
        with self._span("serve/prefill", rid=req.rid,
                        prompt_len=len(req.prompt)):
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
            # eviction = page frees + a zeroed (scratch) table row
            self._table[slot, :] = 0
            self._release_pages(req)
        req.done.set()

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
            first = self._prefill_paged(tokens, len(chunk),
                                        req.shared_len + pos,
                                        self._table[slot], slot)
        req.chunk_pos = pos + len(chunk)
        req.kv_len = req.shared_len + req.chunk_pos
        if not final:
            return 0
        now = time.perf_counter()
        req.prefilling = False
        req.prefill_s = now - req.admit_t
        req.kv_len = len(req.prompt)
        if self.prefix is not None:
            # the pages are fully written now: register them
            self.prefix.insert(req.prompt, req.pages)
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
            pg = self._alloc_pages(extra)
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
            if self.paged:
                out = self.model.decode_step_paged(
                    self.params, tokens, self.cache["k"], self.cache["v"],
                    torch.from_numpy(self._table).to(self.device),
                    self.cache["lengths"], active, impl=self.decode_impl,
                    **self._scales())
                logits, new_len = out[0], out[-1]
            else:
                logits, _, _, new_len = self.model.decode_step(
                    self.params, tokens, self.cache["k"], self.cache["v"],
                    self.cache["lengths"], active, impl=self.decode_impl)
            self.cache["lengths"] = new_len
            self.decode_ticks += 1
            # the per-token latency point: the pull is the device sync
            next_host = select_next_token(logits).cpu().numpy()
        now = time.perf_counter()
        produced = 0
        for slot, req in active_map.items():
            tok = int(next_host[slot])
            req.kv_len += 1
            req.tokens.append(tok)
            req.token_times.append(now - req.last_t)
            req.last_t = now
            req.last_token = tok
            produced += 1
            reason = self.scheduler.finish_reason(req, tok,
                                                  self.max_seq_len)
            if reason is not None:
                self._finish(slot, reason)
        return produced

    def _propose(self, tokens: torch.Tensor,
                 active: torch.Tensor) -> torch.Tensor:
        """k+1 chained greedy draft decode steps; returns the k proposals
        [S, k] int32 on the device.  The extra step writes the last
        proposal's K/V, so a fully accepted block leaves the draft cache
        aligned with the target's."""
        dc = self._draft_cache
        props = []
        tok = tokens
        for i in range(self.spec_k + 1):
            logits, _, _, dc["lengths"] = self.draft_model.decode_step(
                self.draft_params, tok, dc["k"], dc["v"], dc["lengths"],
                active, impl=self._draft_impl)
            tok = select_next_token(logits.float())
            if i < self.spec_k:
                props.append(tok)
        return torch.stack(props, dim=1)

    def _verify(self, tokens: torch.Tensor, proposals: torch.Tensor,
                active: torch.Tensor) -> np.ndarray:
        """The widened target pass + greedy acceptance + the masked
        lengths advance, all on the device; one read-back of ``[S, W+1]``:
        each slot's W emitted-token candidates then its accepted count."""
        tokens_w = torch.cat([tokens[:, None].to(torch.int32),
                              proposals.to(torch.int32)], dim=1)
        if self.paged:
            logits = self.model.verify_step_paged(
                self.params, tokens_w, self.cache["k"], self.cache["v"],
                torch.from_numpy(self._table).to(self.device),
                self.cache["lengths"], active, impl=self.decode_impl,
                **self._scales())[0]
        else:
            logits, _, _ = self.model.verify_step(
                self.params, tokens_w, self.cache["k"], self.cache["v"],
                self.cache["lengths"], active, impl=self.decode_impl)
        out_tok, accepted = speculative_accept(logits.float(), proposals,
                                               None, 0.0)
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
            proposals = self._propose(tokens, active)
        with self._span("serve/verify_step", active=len(active_map),
                        k=self.spec_k):
            # the per-block latency point: the read-back is the sync
            host = self._verify(tokens, proposals, active)
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
                req.token_times.append((now - req.last_t) if used == 0
                                       else 0.0)
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

    # -- failure + shutdown ----------------------------------------------
    def _fail_request(self, req: Request, err: BaseException) -> None:
        req.error = err
        req.done.set()

    def _poison(self, err: BaseException) -> None:
        """A failed decode tick is fatal for every in-flight request (the
        cache may hold a half-written tick).  Typed propagation —
        requests and submitters see the ORIGINAL exception."""
        self.queue.poison(err)
        self.stage.record_event("poison", error=repr(err))
        for slot in list(self.scheduler.active):
            req = self.scheduler.release(slot, "error")
            if self.paged:
                self._table[slot, :] = 0
                self._release_pages(req)
            self._fail_request(req, err)
        while self._pending:
            self._fail_request(self._pending.popleft(), err)

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
