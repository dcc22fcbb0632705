"""ZeRO-Offload's host tier — the port of ``deepspeed_tpu/runtime/offload.py``
(its host half; the disk tier below it is ``runtime/disk_offload.py``,
which keeps this tier's transfer buffers and streams, and the XLA tier
``runtime/offload_xla.py``).

The device runs forward, backward, unscale, the overflow check and
clipping; the fp32 master and both Adam moments live in host RAM (the
device memory they would take is what offload frees), where the native
CPU Adam (``ops/cpu_adam.py``) updates them and writes the next step's
bf16/fp16 compute copy in the same pass.  Per step, on a CUDA device:

  D2H   every gradient leaf is copied into its own page-locked host
        buffer on a side stream, one event per leaf, all enqueued at once
        (:class:`_PrefetchPuller`); the Adam loop waits on leaf i's event
        while leaf i+1 is still copying.  A ``non_blocking`` copy into
        pageable memory would silently run synchronously, so every
        transfer buffer is pinned.
  Adam  leaf by leaf on the host, the low-precision copy written into the
        leaf's page-locked upload buffer.
  H2D   a worker (:class:`StreamingUploader`) copies each updated leaf to
        a new device tensor on a side stream as soon as its Adam is done
        and waits on its event, so the transfer overlaps the Adam of the
        later leaves.  The compute params are swapped only after every
        upload landed (a failure poisons the optimizer and leaves the old
        compute params in place); each upload buffer belongs to one leaf
        and is written again only in the next step, after its copy's
        event completed.

Every device tensor a side stream reads or writes is ``record_stream``-ed
on it, so the caching allocator never hands its block to another
stream's allocation while the copy is in flight.  On a CPU device (the
tests) the same code runs with plain host tensors and no streams.

:class:`HostOffloadOptimizer` holds one rank's pieces of the master:
the whole tree on one process, its data shards across several (the
reference's ``ShardedHostOffloadOptimizer``: at ZeRO-1/2 each process
stages and updates only its own shard, and the uploaded compute shards
are all-gathered over ``data`` on the device, ``runtime/zero.py``).
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Callable, List, Optional

import torch

from ..ops.cpu_adam import DeepSpeedCPUAdam
from ..utils.logging import logger
from .stages import Stage, WatchdogPool, fault_point, injected_delay, spawn

# ---------------------------------------------------------------------------
# telemetry hook: per-transfer spans (the engine installs its hub's tracer)
# ---------------------------------------------------------------------------
_TRANSFER_TRACER = None


def set_transfer_tracer(tracer):
    """Install (or clear, with None) the tracer that receives the
    ``offload/*`` transfer spans."""
    global _TRANSFER_TRACER
    _TRANSFER_TRACER = tracer


def _transfer_span(name: str, cat: str = "transfer", **args):
    tracer = _TRANSFER_TRACER
    if tracer is None:
        return contextlib.nullcontext()
    return tracer.span(name, cat=cat, **args)


class UploadAborted(RuntimeError):
    """``StreamingUploader.finish()`` raced a concurrent ``abort()``: the
    upload set is incomplete — the caller must poison, never publish."""


#: the shared watchdog plane for every guarded bulk D2H pull
_PULL_POOL = WatchdogPool("ds-offload-pull")


def _pull_timeout() -> float:
    return float(os.environ.get("DS_OFFLOAD_PULL_TIMEOUT", "120"))


def _pinned(shape, dtype, device) -> torch.Tensor:
    """A transfer buffer: page-locked when the tier serves a CUDA
    device, a plain host tensor otherwise."""
    return torch.empty(tuple(shape), dtype=dtype,
                       pin_memory=torch.device(device).type == "cuda")


def _wait_event(ev, timeout_s: float, what: str) -> None:
    """Block until ``ev`` completed, polling, so that a stalled link
    raises after ``timeout_s`` instead of hanging in one native wait."""
    if timeout_s <= 0:
        ev.synchronize()
        return
    deadline = time.monotonic() + timeout_s
    while not ev.query():
        if time.monotonic() > deadline:
            raise RuntimeError(
                f"{what} did not complete within {timeout_s:.0f}s: the "
                "transfer appears stalled")
        time.sleep(2e-5)


def _watchdog_get(x: torch.Tensor, timeout_s: float,
                  what: str = "D2H transfer", out=None) -> torch.Tensor:
    """A device→host copy of ``x`` (into ``out`` when given, casting on
    assignment) run on the shared watchdog pool: a pull that stalls
    inside one native call becomes a RuntimeError after ``timeout_s``.
    The ``offload_pull:pull`` chaos boundary runs on the pool's worker."""
    nbytes = x.numel() * x.element_size()

    def _pull():
        delay = injected_delay("offload_pull")
        if delay > 0:
            time.sleep(delay)
        fault_point("offload_pull", "pull")
        if out is None:
            return x.detach().to("cpu", copy=True)
        out.copy_(x)
        return out

    return _PULL_POOL.call(
        _pull, timeout_s, what,
        timeout_msg=(f"{what} ({nbytes >> 20} MB) did not complete within "
                     f"{timeout_s:.0f}s: bulk D2H appears stalled"))


def pull_chunk_bytes() -> int:
    """Piece size of the guarded pulls (``DS_OFFLOAD_PULL_CHUNK_MB``,
    default 64; <= 0 pulls whole leaves)."""
    return int(float(os.environ.get("DS_OFFLOAD_PULL_CHUNK_MB", "64"))
               * (1 << 20))


def chunked_device_get(x: torch.Tensor, chunk_mb: Optional[float] = None,
                       piece_timeout: Optional[float] = None,
                       what: str = "master pull", out=None) -> torch.Tensor:
    """Piece-wise guarded device→host pull: flat element ranges of at most
    ``chunk_mb`` each, every piece under its own watchdog, written
    straight into ``out`` (host memory stays at one copy of the leaf).
    A host tensor is copied (into ``out``, or a private copy)."""
    chunk = (int(chunk_mb * (1 << 20)) if chunk_mb is not None
             else pull_chunk_bytes())
    if piece_timeout is None:
        piece_timeout = _pull_timeout()
    if out is None:
        out = torch.empty(x.shape, dtype=x.dtype)
    if not x.is_cuda:
        return out.copy_(x)
    nbytes = x.numel() * x.element_size()
    with _transfer_span("offload/d2h", what=what, bytes=int(nbytes)):
        if piece_timeout <= 0:
            return out.copy_(x)
        if chunk <= 0 or nbytes <= chunk or x.ndim == 0:
            return _watchdog_get(x, piece_timeout, what, out)
        per = max(1, chunk // x.element_size())
        flat, oflat = x.reshape(-1), out.view(-1)
        for s in range(0, flat.numel(), per):
            _watchdog_get(flat[s:s + per], piece_timeout,
                          f"{what} piece [{s}:{s + per}]", oflat[s:s + per])
        return out


class _PrefetchPuller:
    """One step's gradient D2H: each leaf copied into its page-locked
    buffer ``bufs[i]`` on the side stream ``stream`` (after the compute
    stream's work that produced the grads), one event per leaf, all
    enqueued at construction.  ``self(i, g)`` waits on leaf i's event —
    the Adam loop consumes leaf i while the later copies run — and
    returns the host buffer.  ``seconds``/``bytes``: the copies' device
    time and size (read after consumption).  Host tensors pass through."""

    def __init__(self, grads: List[torch.Tensor], bufs, stream=None):
        self._bufs = bufs
        self._events = None
        self.seconds = 0.0
        self.bytes = 0
        self._timer = None
        cuda = [g for g in grads if g is not None and g.is_cuda]
        if not cuda:
            return
        main = torch.cuda.current_stream(cuda[0].device)
        stream.wait_stream(main)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        self._events = []
        with torch.cuda.stream(stream):
            t0.record(stream)
            for g, buf in zip(grads, bufs):
                ev = None
                if buf is not None:
                    buf.copy_(g, non_blocking=True)
                    g.record_stream(stream)
                    ev = torch.cuda.Event()
                    ev.record(stream)
                    self.bytes += g.numel() * g.element_size()
                self._events.append(ev)
            t1.record(stream)
        self._timer = (t0, t1)

    def __call__(self, i: int, g: torch.Tensor) -> torch.Tensor:
        delay = injected_delay("offload_pull")
        if delay > 0:
            time.sleep(delay)
        fault_point("offload_pull", "pull")
        if self._events is None:
            return g.float().contiguous()
        if self._events[i] is None:
            return g  # not an Adam leaf: no buffer, nothing copied
        _wait_event(self._events[i], _pull_timeout(), f"grad pull leaf {i}")
        return self._bufs[i]

    def close(self) -> None:
        if self._timer is not None:
            self._timer[1].synchronize()
            self.seconds = self._timer[0].elapsed_time(self._timer[1]) / 1e3


class StreamingUploader:
    """The H2D stage of the streaming update: one worker runs
    ``put_fn(idx, host_tensor) -> (device tensor, event or None)`` for
    each leaf submitted from the Adam loop and waits on the event inside
    the leaf's ``offload/h2d_params`` span and timing window, so leaf
    i-1's upload runs while the Adam works on leaf i.

    ``finish()`` waits for every upload and returns ``(results,
    timings)``, ``timings`` being ``[(idx, t_start, t_end, nbytes)]`` in
    host ``perf_counter`` seconds (the overlap accounting).  A
    non-transient failure stops the worker and ``finish()`` re-raises it
    — the caller poisons the optimizer and keeps the old compute params.
    Transient failures (``OSError``, the injected ``offload_h2d:put``
    faults) retry up to the stage's budget, then degrade the stage: the
    upload still completes and the engine takes the serial path from the
    next step on."""

    def __init__(self, put_fn, what: str = "offload/h2d_params",
                 stage: Optional[Stage] = None):
        self._put = put_fn
        self._what = what
        self._stage = stage if stage is not None else Stage("offload_h2d")
        self._q: list = []
        self._cond = threading.Condition()
        self._closed = False
        self._aborted = False
        self._err: Optional[BaseException] = None
        self._err_surfaced = False
        self._finish_owns_err = False
        self._done = threading.Event()
        self.results: dict = {}
        self.timings: list = []
        spawn(self._work, name="ds-offload-h2d", restarts=0)

    def _put_and_drain(self, idx: int, arr):
        out, ev = self._put(idx, arr)
        if ev is not None:
            # drain inside the span: the copy only enqueued, and a late
            # failure must surface before finish() succeeds
            _wait_event(ev, _pull_timeout(), f"param upload leaf {idx}")
        return out

    def _work(self):
        while True:
            with self._cond:
                self._cond.wait_for(lambda: self._q or self._closed)
                if not self._q:
                    break
                idx, arr, ctx = self._q.pop(0)
            if self._err is not None:
                continue  # poisoned: drain submissions, touch nothing
            nbytes = arr.numel() * arr.element_size()
            t0 = time.perf_counter()
            try:
                with _transfer_span(self._what, leaf=idx, bytes=nbytes):
                    tracer = _TRANSFER_TRACER
                    if ctx is not None and tracer is not None:
                        tracer.flow_end("offload/upload", ctx,
                                        cat="offload", leaf=idx)
                    out = self._stage.call(
                        "put", lambda: self._put_and_drain(idx, arr))
            except BaseException as e:  # re-raised from finish()
                with self._cond:
                    self._err = e
                    surface = self._aborted and not self._err_surfaced
                    if surface:
                        self._err_surfaced = True
                if surface:
                    self._stage.surface(e)
                continue
            self.results[idx] = out
            self.timings.append((idx, t0, time.perf_counter(), nbytes))
        self._done.set()

    def submit(self, idx: int, arr):
        """Enqueue leaf ``idx``'s updated host tensor (never blocks on
        the transfer); its causal flow ends in the upload's span."""
        ctx = None
        tracer = _TRANSFER_TRACER
        if tracer is not None and hasattr(tracer, "flow_start"):
            from ..telemetry.tracing import TraceContext
            ctx = TraceContext.new()
            tracer.flow_start("offload/upload", ctx, cat="offload",
                              leaf=idx)
        with self._cond:
            self._q.append((idx, arr, ctx))
            self._cond.notify_all()

    def finish(self):
        """Close the queue, wait for every upload, raise the first
        failure (:class:`UploadAborted` after a concurrent abort)."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._done.wait()
        with self._cond:
            err = self._err
            if err is not None and not self._err_surfaced:
                self._err_surfaced = True
                self._finish_owns_err = True
            owns = self._finish_owns_err
            aborted = self._aborted
        if err is not None and owns:
            raise err
        if aborted:
            raise UploadAborted(
                "streamed offload upload aborted mid-step (engine close/"
                "abort): queued uploads were dropped; the step must "
                "poison, not publish")
        return self.results, self.timings

    def abort(self):
        """Release the worker without waiting (queued uploads dropped);
        a recorded failure no ``finish()`` claimed surfaces through the
        stage record."""
        with self._cond:
            self._closed = True
            self._aborted = True
            self._q.clear()
            err = self._err
            surface = err is not None and not self._err_surfaced
            if surface:
                self._err_surfaced = True
            self._cond.notify_all()
        if surface:
            self._stage.surface(err)


class HostOffloadOptimizer:
    """The host master and moments of one rank's pieces, the CPU Adam, the
    transfer buffers and the side stream.  ``master_pieces``: the rank's
    master leaves on the device (``runtime.utils.tree_leaves`` order);
    they are pulled to the host once and never go back whole."""

    def __init__(self, master_pieces: List[torch.Tensor], lr, betas, eps,
                 weight_decay, adamw_mode: bool = True,
                 bias_correction: bool = True,
                 compute_dtype=torch.bfloat16,
                 use_native: Optional[bool] = None, device=None):
        self.device = torch.device(device if device is not None else
                                   (master_pieces[0].device
                                    if master_pieces else "cpu"))
        self._probe_transfer_path(master_pieces)
        self._poisoned: Optional[BaseException] = None
        self.last_d2h_seconds = 0.0
        self.last_d2h_bytes = 0

        def to_host(x):
            dt = torch.float32 if x.is_floating_point() else x.dtype
            return chunked_device_get(x, what="master pull",
                                      out=torch.empty(x.shape, dtype=dt))

        self.master: List[torch.Tensor] = [to_host(x) for x in master_pieces]
        self.opt = DeepSpeedCPUAdam(
            lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
            adamw_mode=adamw_mode, bias_correction=bias_correction,
            use_native=use_native)
        self.compute_dtype = compute_dtype
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        adam = [p.dtype == torch.float32 for p in self.master]
        # the transfer buffers, one per Adam leaf, reused every step
        self._grad_bufs = [_pinned(p.shape, torch.float32, self.device)
                           if a else None
                           for p, a in zip(self.master, adam)]
        self._up_bufs = [_pinned(p.shape, compute_dtype, self.device)
                         if a else None
                         for p, a in zip(self.master, adam)]

    @staticmethod
    def _probe_transfer_path(pieces, min_mbps: float = None,
                             probe_timeout: float = None):
        """Fail fast (or warn) when bulk device→host transfers are broken
        or slower than ``DS_OFFLOAD_MIN_MBPS`` (default 8; 0 disables):
        one guarded pull of up to ~4 MB of the largest leaf, timed.  A
        slow but working link warns and proceeds (every later pull is
        chunked and watchdogged); ``DS_OFFLOAD_SLOW_LINK=error`` makes it
        fatal.  ``DS_OFFLOAD_PROBE_TIMEOUT`` seconds (default 60)."""
        if min_mbps is None:
            min_mbps = float(os.environ.get("DS_OFFLOAD_MIN_MBPS", "8"))
        if probe_timeout is None:
            probe_timeout = float(
                os.environ.get("DS_OFFLOAD_PROBE_TIMEOUT", "60"))
        leaves = [x for x in pieces if x.is_cuda]
        if min_mbps <= 0 or not leaves:
            return
        leaf = max(leaves, key=lambda x: x.numel() * x.element_size())
        nbytes = leaf.numel() * leaf.element_size()
        if nbytes > 4 << 20 and leaf.ndim >= 1 and leaf.shape[0] > 1:
            leaf = leaf[:max(1, int(leaf.shape[0] * (4 << 20) / nbytes))]
            nbytes = leaf.numel() * leaf.element_size()
        if nbytes < 1 << 20:
            return  # tiny models: nothing worth probing
        t0 = time.perf_counter()
        _watchdog_get(leaf, probe_timeout, "device->host transfer probe")
        mbps = (nbytes / (1 << 20)) / max(time.perf_counter() - t0, 1e-9)
        if mbps < min_mbps:
            msg = (f"device->host transfer probe measured {mbps:.1f} MB/s "
                   f"(< {min_mbps} MB/s): the host offload tier would take "
                   "minutes per step at this bandwidth; set "
                   "DS_OFFLOAD_MIN_MBPS=0 to skip this probe.")
            if os.environ.get("DS_OFFLOAD_SLOW_LINK", "warn") == "error":
                raise RuntimeError(msg)
            logger.warning("%s Proceeding anyway (DS_OFFLOAD_SLOW_LINK="
                           "warn): every device->host pull is chunked and "
                           "watchdogged.", msg)

    @property
    def is_native(self) -> bool:
        return self.opt.is_native

    @property
    def staged_bytes(self) -> int:
        """Host bytes of this rank's master and moments."""
        return 3 * sum(p.numel() * p.element_size() for p in self.master)

    def compute_params(self) -> List[torch.Tensor]:
        """The compute-dtype copies of the master, in the upload buffers
        (non-floating leaves pass through)."""
        out = []
        for p, buf in zip(self.master, self._up_bufs):
            out.append(p.clone() if buf is None else buf.copy_(p))
        return out

    def upload(self, i: int, host: torch.Tensor):
        """Leaf ``i``'s host copy to a new device tensor: ``(tensor,
        event)`` — on a CUDA device copied on the side stream (the event
        marks its end), else ``(copy, None)``."""
        if self._stream is None:
            return host.clone(), None
        dst = torch.empty(host.shape, dtype=host.dtype, device=self.device)
        with torch.cuda.stream(self._stream):
            dst.copy_(host, non_blocking=True)
            dst.record_stream(self._stream)
            ev = torch.cuda.Event()
            ev.record(self._stream)
        return dst, ev

    def upload_all(self, hosts: List[torch.Tensor]) -> List[torch.Tensor]:
        """Every leaf uploaded and waited on (the serial path)."""
        pairs = [self.upload(i, h) for i, h in enumerate(hosts)]
        for _, ev in pairs:
            if ev is not None:
                _wait_event(ev, _pull_timeout(), "param upload")
        return [t for t, _ in pairs]

    def pull(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The delayed update's host stash of ``grads``, every copy
        waited on (the reference's ``guarded_tree_pull``); the copies'
        device time and bytes go to ``last_d2h_seconds``/``_bytes``,
        which the stash's later ``step`` leaves as they are."""
        puller = _PrefetchPuller(grads, self._grad_bufs, self._stream)
        try:
            return [puller(i, g) for i, g in enumerate(grads)]
        finally:
            puller.close()
            self.last_d2h_seconds = puller.seconds
            self.last_d2h_bytes = puller.bytes

    def step(self, grads: List[torch.Tensor],
             on_leaf: Optional[Callable] = None) -> List[torch.Tensor]:
        """Update the master and moments in place from ``grads`` (device
        tensors, or the host stash) and return each leaf's compute-dtype
        host copy; ``on_leaf(i, copy)`` fires the moment leaf ``i`` is
        written (the streaming upload's hook).  A failure mid-step leaves
        the leaves partially updated: the optimizer poisons itself, and
        ``step``/``state_tree`` refuse until ``load_state_tree``."""
        if self._poisoned is not None:
            raise RuntimeError(
                "HostOffloadOptimizer is poisoned: a previous step failed "
                "mid-update, leaving master/moments inconsistent. Restore "
                f"from a checkpoint. Original error: {self._poisoned!r}")
        puller = _PrefetchPuller(grads, self._grad_bufs, self._stream)
        outs: list = [None] * len(self.master)
        lowp = (self.compute_dtype
                if self.compute_dtype != torch.float32 else None)
        try:
            for i, out in self.opt.step_leaves(
                    self.master, grads, out_dtype=lowp, leaf_get=puller,
                    leaf_span=lambda i: _transfer_span(
                        "offload/adam_leaf", cat="offload", leaf=i),
                    outs=self._up_bufs):
                if out is None:
                    # fp32 compute: the updated master leaf's copy
                    buf = self._up_bufs[i]
                    out = (self.master[i].clone() if buf is None
                           else buf.copy_(self.master[i]))
                outs[i] = out
                if on_leaf is not None:
                    on_leaf(i, out)
        except BaseException as e:
            self._poisoned = e
            raise
        finally:
            puller.close()
            if puller.bytes:
                self.last_d2h_seconds = puller.seconds
                self.last_d2h_bytes = puller.bytes
        return outs

    def poison(self, err: BaseException) -> None:
        """Mark the optimizer inconsistent from outside the step (an
        upload failed after the Adam: the host carries step t, the device
        would keep t-1)."""
        self._poisoned = err

    def state_tree(self):
        """``{"step", "mu", "nu"}`` over the master's leaves (live views
        of the moments); refuses while poisoned."""
        if self._poisoned is not None:
            raise RuntimeError(
                "refusing to serialize inconsistent optimizer state (a "
                "step failed mid-update). Restore from an earlier "
                f"checkpoint. Original error: {self._poisoned!r}")
        mu, nu = [], []
        for i, p in enumerate(self.master):
            m, v = self.opt._moments(i, p)
            mu.append(m)
            nu.append(v)
        return {"step": self.opt.step_count, "mu": mu, "nu": nu}

    def load_state_tree(self, master, step: int, mu=None, nu=None) -> None:
        """In-place restore (the buffers keep their identity); ``mu`` None
        starts the moments afresh.  Clears the poison."""
        self._poisoned = None
        for dst, src in zip(self.master, master):
            dst.copy_(src)
        self.opt.step_count = int(step)
        for i, p in enumerate(self.master):
            m, v = self.opt._moments(i, p)
            if mu is None:
                m.zero_()
                v.zero_()
            else:
                m.copy_(mu[i])
                v.copy_(nu[i])
