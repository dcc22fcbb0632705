"""ServeEngine — the KV-cached greedy decode engine (docs/serving.md),
ported to PyTorch on the unpaged slot cache.

Requests stream through a bounded queue into a FIXED pool of decode
slots, and two steps serve every mix:

  prefill      one request's prompt (right-padded to the static
               ``serving.prefill_len`` bucket) → its K/V rows written
               into the assigned slot + the first greedy token.  Runs the
               flash-attention forward kernel on ``attn_impl="flash"``.
  decode tick  ONE masked tick for ALL slots at once: each active slot's
               last token in, its next greedy token out, its K/V appended
               in place.  Free/finished slots ride along masked.  Runs the
               single-query decode-attention kernel.

Admission/eviction are the continuous-batching moves (Orca, PAPERS.md):
a finished slot is refilled on the very next tick.

Fault plane: the request queue is a stages :class:`Channel` and all
serving work runs under one :class:`Stage` record ("serve", points
``admit``/``step``), so poison/drain semantics, graceful degradation and
the ``DS_STAGE_FAULT``/``DS_STAGE_DELAY_S`` spec apply as in the JAX
engine.

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
from typing import Optional

import numpy as np
import torch

from ..config.config import (DeepSpeedConfig, DeepSpeedServingConfig,
                             DeepSpeedStagesConfig,
                             DeepSpeedTelemetryConfig)
from ..config import constants as C
from ..models.gpt2 import _decode_attn_impl
from ..runtime.engine_stages import wire_serve_stage_plane
from ..runtime.stages import Channel, Stage
from ..utils.logging import logger
from .kv_cache import KVCacheSpec, init_cache
from .scheduler import Request, SlotScheduler
from .speculative import select_next_token


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
    if sv.page_len > 0:
        raise _unported("serving.page_len > 0 (paged KV)",
                        "item 7.2 (paged KV)")
    if sv.prefill_chunk_len > 0:
        raise _unported("serving.prefill_chunk_len > 0 (chunked prefill)",
                        "item 7.2 (paged KV)")
    if sv.speculate_k > 0:
        raise _unported("serving.speculate_k > 0 (speculative decoding)",
                        "item 7.3 (speculation and sampling)")
    if sv.temperature > 0:
        raise _unported("serving.temperature > 0 (sampling)",
                        "item 7.3 (speculation and sampling)")
    q = sv.quantization
    if (q[C.SERVING_QUANT_WEIGHTS] != C.SERVING_QUANT_WEIGHTS_DEFAULT
            or q[C.SERVING_QUANT_KV] != C.SERVING_QUANT_KV_DEFAULT):
        raise _unported("serving.quantization (int8 weights / KV)",
                        "item 7.4 (quantized serving)")
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
    ``prefill(params, tokens) -> (logits, k, v)`` and
    ``decode_step(params, tokens, k, v, lengths, active, impl=...)``.
    ``params`` is a parameter tree of tensors (moved to ``device``);
    None draws one from ``model.init(seed)`` on the device.
    """

    def __init__(self, model, config=None, mesh=None, params=None,
                 seed: int = 0, device=None):
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

        # -- params + cache on the device ---------------------------------
        if params is None:
            params = model.init(seed, device=self.device)
        self.params = _to_device(params, self.device)
        self.cache_spec = KVCacheSpec(
            layers=mcfg.n_layer, slots=self.slots, heads=mcfg.n_head,
            max_len=self.max_seq_len, head_dim=mcfg.d_head,
            dtype=self.params["wte"].dtype)
        self.cache = init_cache(self.cache_spec, self.device)

        # -- fault plane: queue as a Channel, work under one Stage -------
        self.queue = Channel(capacity=cfg.serving.queue_capacity)
        self.scheduler = SlotScheduler(self.slots)
        self.stage = Stage(
            "serve", max_failures=cfg.stages.max_stage_failures,
            fallback="chaos-free direct serving (injection plane "
                     "bypassed)")
        # flight recorder: every stage event samples the queue depth
        self.stage.depth_fn = self.queue.qsize
        wire_serve_stage_plane(self)

        self._rid = 0
        #: decode ticks that ran the model (each launches the decode
        #: kernel once per layer)
        self.decode_ticks = 0
        self._closed = False
        #: requests popped from the queue but not yet admitted
        self._pending: deque = deque()

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
        ``adapter_id`` keep the JAX engine's surface: both need planes
        not ported yet (paged KV, LoRA), so they are refused as there."""
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
        if detach_kv:
            raise ValueError(
                "detach_kv (KV-migration handoff) requires the paged "
                "layout (serving.page_len > 0)")
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

    def _admit_one_slot(self, req: Request) -> bool:
        tokens = np.zeros((1, self.prefill_len), np.int64)
        tokens[0, :len(req.prompt)] = req.prompt
        req.admit_t = time.perf_counter()
        with self._span("serve/prefill", rid=req.rid,
                        prompt_len=len(req.prompt)):
            first = self._prefill(torch.from_numpy(tokens).to(self.device),
                                  len(req.prompt), self.scheduler.free[0])
        now = time.perf_counter()
        req.prefill_s = now - req.admit_t
        slot = self.scheduler.admit(req, now=now)
        req.kv_len = len(req.prompt)
        req.tokens.append(first)
        req.token_times.append(now - req.submit_t)
        req.last_token = first
        reason = self.scheduler.finish_reason(req, first,
                                              self.max_seq_len)
        if reason is not None:
            self._finish(slot, reason)
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
                self.stage.call(
                    "admit", lambda r=req: self._admit_one_slot(r),
                    path=f"rid={req.rid}")
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

    def _finish(self, slot: int, reason: str) -> None:
        req = self.scheduler.release(slot, reason)
        req.done.set()

    # -- the decode tick --------------------------------------------------
    def _decode_tick(self) -> int:
        active_map = dict(self.scheduler.active)
        if not active_map:
            return 0
        tokens = np.zeros((self.slots,), np.int64)
        active = np.zeros((self.slots,), bool)
        for slot, req in active_map.items():
            tokens[slot] = req.last_token
            active[slot] = True
        with self._span("serve/decode_step", active=len(active_map)):
            logits, _, _, new_len = self.model.decode_step(
                self.params, torch.from_numpy(tokens).to(self.device),
                self.cache["k"], self.cache["v"], self.cache["lengths"],
                torch.from_numpy(active).to(self.device),
                impl=self.decode_impl)
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

    def step(self) -> int:
        """One serving tick: admit into free slots, then one masked decode
        over the whole pool.  Returns tokens produced."""
        if self._closed:
            raise RuntimeError("ServeEngine is closed")
        self._admit()
        try:
            n = self.stage.call("step", self._decode_tick)
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
            self._fail_request(self.scheduler.release(slot, "error"), err)
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
