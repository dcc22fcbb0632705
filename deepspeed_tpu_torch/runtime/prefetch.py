"""Asynchronous input pipeline — the port of ``deepspeed_tpu/runtime/
prefetch.py``: ``DevicePrefetcher`` pulls batches ahead of consumption on
one stage worker, through a bounded channel (default depth 2), and
places them on the card there.

Placement on a CUDA device: the worker copies each host leaf into
page-locked memory and from there to the card on a side stream, records
an event and waits on it INSIDE its ``data/prefetch_place`` span, so a
queued batch is resident (not merely enqueued) and a failed copy poisons
the iterator instead of escaping into the consuming step.  The consumer
(``DevicePlacedBatch.ready``) makes its stream wait on the event and
records the batch's tensors on its stream, so the caching allocator
keeps their blocks until the step that reads them is done.

Contracts (the JAX module's): ``StopIteration`` propagates after every
produced batch is consumed and the iterator stays exhausted; a
non-transient worker failure poisons the channel and the consumer
re-raises the ORIGINAL exception (after draining batches produced before
it); transient failures (``OSError``, injected ``DS_STAGE_FAULT=
prefetch:place:n`` faults) retry the same batch up to the stage's budget,
then degrade it to inline iteration with one warning — every batch still
arrives, in order; ``close()`` is idempotent and releases the worker; a
checkpointable source's ``state_dict()`` is the state of the last
CONSUMED batch (prefetched batches count as not drawn).  ``DS_PREFETCH=
0`` turns the engine's prefetch off; ``DS_STAGE_DELAY_S=prefetch:<s>``
sleeps inside each placement span.
"""
from __future__ import annotations

import contextlib
import copy
import threading
import time
from typing import Any, Callable, Optional

import torch

from ..telemetry.tracing import TraceContext
from .stages import Channel, Stage, spawn

__all__ = ["DevicePlacedBatch", "DevicePrefetcher"]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


class DevicePlacedBatch:
    """A batch ALREADY placed on the device (the prefetcher's product);
    the engine skips its own placement for it.  ``kind``: which
    placement made it ("train": the accumulation layout; "eval": a flat
    micro-batch); ``event``: the side-stream copy's completion on a CUDA
    device (None otherwise)."""

    __slots__ = ("tree", "kind", "ctx", "event")

    def __init__(self, tree: Any, kind: str = "train", ctx: Any = None,
                 event: Any = None):
        self.tree = tree
        self.kind = kind
        self.ctx = ctx
        self.event = event

    def ready(self) -> Any:
        """The tree, usable on the current stream: the stream waits on
        the copy's event and each tensor is recorded on it."""
        if self.event is not None:
            stream = torch.cuda.current_stream()
            stream.wait_event(self.event)
            for t in _leaves(self.tree):
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    t.record_stream(stream)
        return self.tree


def place_on_device(tree, device, stream=None):
    """``(tree on device, event)``: on a CUDA device every host leaf is
    page-locked and copied on ``stream`` (a side stream), every device
    tensor recorded on it, and the returned event marks the copies' end;
    elsewhere ``(tree moved, None)``."""
    device = torch.device(device)

    def leaf(x):
        return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)

    def walk(t, fn):
        if isinstance(t, dict):
            return {k: walk(v, fn) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(walk(v, fn) for v in t)
        return fn(leaf(t))

    if device.type != "cuda":
        return walk(tree, lambda x: x.to(device)), None
    if stream is None:
        stream = torch.cuda.current_stream(device)

    def put(x):
        if x.is_cuda:
            return x
        src = x if x.is_pinned() else x.pin_memory()
        with torch.cuda.stream(stream):
            d = src.to(device, non_blocking=True)
            d.record_stream(stream)
        return d

    out = walk(tree, put)
    with torch.cuda.stream(stream):
        ev = torch.cuda.Event()
        ev.record(stream)
    return out, ev


class _End:
    """Queue sentinel: the source raised StopIteration."""

    __slots__ = ()


_END = _End()


class DevicePrefetcher:
    """Wrap a batch iterator with one stage worker and a bounded channel,
    pulling batches ahead of consumption.  ``place_fn(batch)`` runs on the
    worker and returns a :class:`DevicePlacedBatch` (or a plain tree);
    the worker waits on the batch's event before queueing it.
    ``span_fn`` receives the ``data/prefetch_place`` (worker) and
    ``data/prefetch_wait`` (consumer) spans; ``stage`` is the engine's
    persistent ``prefetch`` record.  ``stats()``: cumulative ``hits``
    (batch already queued when asked for), ``misses``, ``wait_s`` and
    ``consumed``."""

    def __init__(self, source, place_fn: Optional[Callable] = None,
                 depth: int = 2, span_fn: Optional[Callable] = None,
                 name: str = "train", stage: Optional[Stage] = None,
                 tracer: Optional[Any] = None):
        if not isinstance(depth, int) or isinstance(depth, bool) \
                or depth < 1:
            raise ValueError(f"prefetch depth must be an int >= 1, "
                             f"got {depth!r}")
        from .dataloader import supports_iter_state
        self._state_src = source if supports_iter_state(source) else None
        self._consumed_state = None
        if self._state_src is not None:
            try:
                self._consumed_state = copy.deepcopy(
                    self._state_src.state_dict())
            except TypeError:
                self._state_src = None
        self._src = source if hasattr(source, "__next__") else iter(source)
        self._place = place_fn if place_fn is not None else (lambda b: b)
        self._span = span_fn if span_fn is not None else (
            lambda *a, **k: contextlib.nullcontext())
        self.depth = depth
        self.name = name
        self._tracer = tracer
        self.stage = stage if stage is not None else Stage("prefetch")
        self._chan = Channel(depth)
        self.stage.depth_fn = self.qsize
        self._ended = False
        self._worker_inline = False
        self._inline_lock = threading.Lock()
        self._hits = 0
        self._misses = 0
        self._wait_s = 0.0
        self._consumed = 0
        self._worker = spawn(self._work,
                             name=f"ds-data-prefetch-{name}", restarts=0)

    def _open_flow(self, placed):
        """Stamp a placed batch with a TraceContext and open its flow,
        inside the ``data/prefetch_place`` span."""
        if self._tracer is not None \
                and isinstance(placed, DevicePlacedBatch):
            placed.ctx = TraceContext.new()
            self._tracer.flow_start("data/batch", placed.ctx, cat="data")
        return placed

    def _place_and_drain(self, item):
        placed = self._place(item)
        ev = placed.event if isinstance(placed, DevicePlacedBatch) else None
        if ev is not None:
            ev.synchronize()
        return placed

    def _work(self):
        try:
            self._produce()
        except BaseException as e:
            self._chan.poison(e)
            raise

    def _produce(self):
        batch_idx = 0
        while True:
            if not self._chan.wait_space():
                return  # closed
            if self.stage.degraded:
                with self._chan.cond:
                    self._worker_inline = True
                    self._chan.cond.notify_all()
                return
            try:
                item = next(self._src)
                post_state = (copy.deepcopy(self._state_src.state_dict())
                              if self._state_src is not None else None)
            except StopIteration:
                self._chan.put((_END, None), force=True)  # after every batch
                return
            except BaseException as e:  # poison: the consumer re-raises
                self._chan.poison(e)
                return
            try:
                with self._span("data/prefetch_place", cat="data",
                                batch=batch_idx):
                    placed = self.stage.call(
                        "place", lambda: self._place_and_drain(item))
                    placed = self._open_flow(placed)
            except BaseException as e:
                self._chan.poison(e)
                return
            batch_idx += 1
            if not self._chan.put((placed, post_state)):
                return  # closed while parked

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        with self._span("data/prefetch_wait", cat="data"):
            with self._chan.cond:
                if self._ended:
                    raise StopIteration
                if self._chan.closed:
                    raise RuntimeError(
                        "DevicePrefetcher is closed (engine.close() shut "
                        "it down)")
                hit = bool(self._chan.items)
                self._chan.cond.wait_for(
                    lambda: self._chan.items or self._chan.err is not None
                    or self._chan.closed or self._worker_inline)
                if self._chan.closed:
                    raise RuntimeError(
                        "DevicePrefetcher closed while waiting for a "
                        "batch")
                if self._chan.items:
                    item, post_state = self._chan.items.pop(0)
                    self._chan.cond.notify_all()  # a slot freed
                    if isinstance(item, _End):
                        self._ended = True
                        self._chan.closed = True
                        raise StopIteration
                    if post_state is not None:
                        self._consumed_state = post_state
                    self._hits += 1 if hit else 0
                    self._misses += 0 if hit else 1
                    self._wait_s += time.perf_counter() - t0
                    self._consumed += 1
                    return item
                if self._chan.err is not None:
                    raise self._chan.err
            return self._next_inline(t0)

    def _next_inline(self, t0: float):
        """Degraded mode: pull, place and drain on the consumer's thread,
        outside the injection plane (same batches, order and resume
        accounting)."""
        with self._inline_lock:
            with self._chan.cond:
                if self._ended:
                    raise StopIteration
                if self._chan.err is not None:
                    raise self._chan.err
                if self._chan.closed:
                    raise RuntimeError(
                        "DevicePrefetcher is closed (engine.close() shut "
                        "it down)")
            try:
                item = next(self._src)
                post_state = (copy.deepcopy(self._state_src.state_dict())
                              if self._state_src is not None else None)
            except StopIteration:
                with self._chan.cond:
                    self._ended = True
                    self._chan.closed = True
                raise
            except BaseException as e:
                self._chan.poison(e)
                raise
            try:
                with self._span("data/prefetch_place", cat="data",
                                inline=True):
                    placed = self._place_and_drain(item)
                    placed = self._open_flow(placed)
            except BaseException as e:
                self._chan.poison(e)
                raise
            if post_state is not None:
                self._consumed_state = post_state
            self._misses += 1
            self._wait_s += time.perf_counter() - t0
            self._consumed += 1
            return placed

    def qsize(self) -> int:
        """Batches ready for consumption (the epoch-end sentinel does not
        count)."""
        with self._chan.cond:
            return len([x for x, _ in self._chan.items
                        if not isinstance(x, _End)])

    def stats(self) -> dict:
        with self._chan.cond:
            return {"hits": self._hits, "misses": self._misses,
                    "wait_s": self._wait_s, "consumed": self._consumed}

    def state_dict(self):
        """The source's state at the consumption point (queued batches
        count as not yet drawn); TypeError for a source that is not
        checkpointable."""
        if self._state_src is None:
            raise TypeError(
                f"DevicePrefetcher({self.name}): source "
                f"{type(self._src).__name__} has no state_dict/"
                "load_state_dict — pass the loader object to prefetch()")
        with self._chan.cond:
            if self._chan.err is not None:
                raise self._chan.err
            return copy.deepcopy(self._consumed_state)

    @property
    def closed(self) -> bool:
        return self._chan.closed

    def close(self) -> None:
        """Idempotent: release the worker and drop queued batches (and the
        stage's depth sampler when it is this prefetcher's)."""
        if self.stage.depth_fn == self.qsize:
            self.stage.depth_fn = None
        self._chan.close()
