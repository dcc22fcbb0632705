"""ZeRO-Infinity's disk tier — the port of
``deepspeed_tpu/runtime/disk_offload.py``: the fp32 master and both Adam
moments live in one CRC'd file per parameter leaf under
``offload.disk_dir``, and host RAM holds only a bounded window of leaves
(``io_depth`` read-ahead + the leaf in update + ``io_depth`` write-back),
so trainable size is capped by the disk, not the RAM.

While the native CPU Adam updates leaf i,

  - leaf i+1's state is being READ (the ``disk_read`` stage worker,
    bounded read-ahead through a :class:`~.stages.Channel`),
  - leaf i-1's updated state is being WRITTEN back (the ``disk_write``
    stage worker, tmp+rename with CRC, bounded queue), and
  - leaf i-1's compute copy is uploading to the card (the engine's
    ``StreamingUploader`` via ``on_leaf``, unchanged).

Every file read and write is one ``Stage.call`` (the ``disk_read:read``
and ``disk_write:write`` fault points): transient ``OSError``s retry under
``io_retry`` and the stage's failure budget, and an exhausted budget
degrades to the serial read-update-write loop — bitwise the pipelined
one.  A CRC mismatch raises :class:`DiskStateCorruptError` before the
bytes reach the Adam; the optimizer poisons, and a checkpoint restore
(``load_state_tree``) rewrites every leaf file.

The Adam entry is ``DeepSpeedCPUAdam.apply_leaf``, the call the host tier
makes, so disk-tier training is bitwise the host tier's.  The files are
the JAX package's (magic, JSON header, sections in the same order, the
same storage dtypes), so state written by either package reads in the
other.  Gradients come down and compute copies go up through the host
tier's pinned buffers and side stream (:class:`~.offload.
HostOffloadOptimizer`, whose transfer methods this class keeps).
"""
from __future__ import annotations

import io
import json
import os
import struct
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.cpu_adam import DeepSpeedCPUAdam, lowp_kind
from ..utils.logging import logger
from .checkpointing import _from_storage, _to_storage
from .offload import (HostOffloadOptimizer, _PrefetchPuller, _pinned,
                      _transfer_span, chunked_device_get)
from .resilience import (CheckpointCorruptError, DEFAULT_RETRY, RetryPolicy,
                         io_retry)
from .stages import Channel, Stage, spawn

__all__ = ["DiskLeafStore", "DiskOffloadOptimizer", "DiskStateCorruptError",
           "disk_fsync_enabled"]

#: leaf-state file magic (a format change bumps it)
_MAGIC = b"DSDISK1\n"

#: section order inside a leaf file (master first: a master-only read
#: seeks once)
_SECTIONS = ("master", "mu", "nu")


class DiskStateCorruptError(CheckpointCorruptError):
    """A leaf-state file failed verification (magic, length or CRC).
    Typed and not transient: the optimizer poisons and the caller
    restores from a checkpoint."""


def disk_fsync_enabled(config_default: bool = True) -> bool:
    """Per-file fsync before each rename: on unless the ``offload.fsync``
    knob or ``DS_DISK_FSYNC=0`` turns it off (a torn write is still caught
    by the CRC, and tmp+rename keeps the previous good file)."""
    return bool(config_default) and os.environ.get(
        "DS_DISK_FSYNC", "1") != "0"


def _to_tensor(arr) -> torch.Tensor:
    return arr if isinstance(arr, torch.Tensor) else torch.from_numpy(arr)


class DiskLeafStore:
    """One CRC'd binary file per leaf: magic, an 8-byte header length, a
    JSON header naming each section's dtype, shape, CRC32 and byte
    extent, then the raw sections.  Writes go to ``<path>.tmp`` and are
    renamed into place under ``io_retry``; reads verify length and CRC
    per section and raise :class:`DiskStateCorruptError` before returning
    any bytes."""

    def __init__(self, directory: str, fsync: bool = True,
                 retry: RetryPolicy = DEFAULT_RETRY):
        self.directory = directory
        self.fsync = bool(fsync)
        self.retry = retry
        os.makedirs(directory, exist_ok=True)

    def path(self, idx: int) -> str:
        return os.path.join(self.directory, f"leaf_{idx:05d}.state")

    def write(self, idx: int, sections: Dict[str, torch.Tensor]) -> int:
        """Write ``sections`` (a subset of master/mu/nu) for leaf ``idx``;
        returns the payload bytes."""
        header: dict = {"leaf": idx, "sections": {}}
        payload = io.BytesIO()
        total = 0
        for name in _SECTIONS:
            if name not in sections:
                continue
            store, logical = _to_storage(sections[name])
            raw = store.tobytes()
            header["sections"][name] = {
                "dtype": logical,
                "store_dtype": store.dtype.name,
                "shape": list(store.shape),
                "crc32": zlib.crc32(raw) & 0xFFFFFFFF,
                "offset": total,
                "nbytes": len(raw),
            }
            payload.write(raw)
            total += len(raw)
        blob = json.dumps(header).encode()
        path = self.path(idx)
        tmp = path + ".tmp"

        def do_write():
            with open(tmp, "wb") as f:
                f.write(_MAGIC)
                f.write(struct.pack("<Q", len(blob)))
                f.write(blob)
                f.write(payload.getbuffer())
                f.flush()
                if self.fsync:
                    os.fsync(f.fileno())
            os.rename(tmp, path)

        io_retry(do_write, f"disk-tier write {path}", self.retry)
        return total

    def read(self, idx: int, names: Optional[Tuple[str, ...]] = None
             ) -> Dict[str, torch.Tensor]:
        """Leaf ``idx``'s sections (all, or ``names``) as writable CPU
        tensors, CRC-verified; each section is seek-read on its own."""
        path = self.path(idx)

        def do_read():
            out: Dict[str, torch.Tensor] = {}
            with open(path, "rb") as f:
                magic = f.read(len(_MAGIC))
                if magic != _MAGIC:
                    raise DiskStateCorruptError(
                        f"disk-tier state {path}: bad magic {magic!r} "
                        "(truncated or foreign file)")
                (hlen,) = struct.unpack("<Q", f.read(8))
                try:
                    header = json.loads(f.read(hlen))
                except ValueError as e:
                    raise DiskStateCorruptError(
                        f"disk-tier state {path}: unparseable header ({e})")
                base = f.tell()
                for name in (names or _SECTIONS):
                    ent = header["sections"].get(name)
                    if ent is None:
                        raise DiskStateCorruptError(
                            f"disk-tier state {path}: missing section "
                            f"{name!r}")
                    f.seek(base + int(ent["offset"]))
                    raw = f.read(int(ent["nbytes"]))
                    if len(raw) != int(ent["nbytes"]):
                        raise DiskStateCorruptError(
                            f"disk-tier state {path} section {name!r}: "
                            f"{len(raw)} bytes on disk, header records "
                            f"{ent['nbytes']} (truncated write?)")
                    got = zlib.crc32(raw) & 0xFFFFFFFF
                    if got != int(ent["crc32"]):
                        raise DiskStateCorruptError(
                            f"disk-tier state {path} section {name!r}: "
                            f"CRC32 mismatch (stored "
                            f"{int(ent['crc32']):#010x}, computed "
                            f"{got:#010x}) — bit corruption or partial "
                            "write")
                    arr = np.frombuffer(
                        bytearray(raw),
                        dtype=np.dtype(ent["store_dtype"])).reshape(
                            ent["shape"])
                    out[name] = _to_tensor(_from_storage(arr, ent["dtype"]))
            return out

        try:
            return io_retry(do_read, f"disk-tier read {path}", self.retry)
        except FileNotFoundError:
            raise DiskStateCorruptError(f"disk-tier state {path} is missing")


class _DiskLeafView:
    """A lazy handle on one section of one leaf's disk state: its shape,
    dtype and device stand in for the tensor in the engine's state and
    in checkpoint templates, and ``materialize()`` reads it (the
    checkpoint writer streams the master leaf by leaf this way).
    ``to(dtype)`` is a view of the cast."""

    __slots__ = ("_store", "_idx", "_name", "shape", "dtype", "_cast")

    device = torch.device("cpu")

    def __init__(self, store: DiskLeafStore, idx: int, name: str,
                 shape, dtype: torch.dtype,
                 cast: Optional[torch.dtype] = None):
        self._store = store
        self._idx = idx
        self._name = name
        self.shape = torch.Size(shape)
        self.dtype = cast or dtype
        self._cast = cast

    def is_floating_point(self) -> bool:
        return self.dtype.is_floating_point

    def to(self, dtype) -> "_DiskLeafView":
        return _DiskLeafView(self._store, self._idx, self._name,
                             self.shape, self.dtype, cast=dtype)

    def materialize(self) -> torch.Tensor:
        t = self._store.read(self._idx, names=(self._name,))[self._name]
        return t if self._cast is None else t.to(self._cast)

    def __repr__(self):
        return (f"_DiskLeafView({self._name!r}, leaf={self._idx}, "
                f"shape={tuple(self.shape)}, dtype={self.dtype})")


#: end-of-stream sentinel of the pipeline channels
_DONE = object()


class DiskOffloadOptimizer(HostOffloadOptimizer):
    """The single-controller disk tier, in the host tier's interface (the
    engine holds either as ``_host_opt``): the master and moments live
    in per-leaf files; the gradient buffers, upload buffers, side stream
    and transfer methods are the host tier's.

    ``step`` runs the pipeline of the module docstring; a degraded
    ``disk_read``/``disk_write`` stage (or ``DS_DISK_OFFLOAD_PIPELINE=0``)
    runs the serial loop.  ``ram_budget_bytes`` (or
    ``DS_OFFLOAD_DISK_RAM_BUDGET_MB``) bounds the resident leaf-state
    bytes of the window; exceeding it raises."""

    def __init__(self, master_pieces: List[torch.Tensor], lr, betas, eps,
                 weight_decay, adamw_mode: bool = True,
                 bias_correction: bool = True,
                 compute_dtype=torch.bfloat16,
                 use_native: Optional[bool] = None, device=None,
                 disk_dir: str = "", io_depth: int = 2,
                 fsync: bool = True,
                 ram_budget_bytes: Optional[int] = None):
        if not disk_dir:
            raise ValueError("DiskOffloadOptimizer requires disk_dir")
        self.device = torch.device(device if device is not None else
                                   (master_pieces[0].device
                                    if master_pieces else "cpu"))
        self._probe_transfer_path(master_pieces)
        self._poisoned: Optional[BaseException] = None
        self.last_d2h_seconds = 0.0
        self.last_d2h_bytes = 0
        self.last_disk_breakdown: Optional[dict] = None
        self.io_depth = max(1, int(io_depth))
        self._store = DiskLeafStore(disk_dir,
                                    fsync=disk_fsync_enabled(fsync))
        self.opt = DeepSpeedCPUAdam(
            lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
            adamw_mode=adamw_mode, bias_correction=bias_correction,
            use_native=use_native)
        self.compute_dtype = compute_dtype
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        # private stage records until the engine binds its wired ones
        fallback = "the serial read-update-write loop"
        self._read_stage = Stage("disk_read", fallback=fallback)
        self._write_stage = Stage("disk_write", fallback=fallback)
        env_budget = os.environ.get("DS_OFFLOAD_DISK_RAM_BUDGET_MB")
        if env_budget:
            ram_budget_bytes = int(float(env_budget) * (1 << 20))
        self.ram_budget_bytes = ram_budget_bytes
        self._resident_lock = threading.Lock()
        self._resident_bytes = 0
        self.peak_resident_bytes = 0
        self._abort = False
        self._inflight: list = []
        #: the current step's write-back completion: a restore fences on
        #: it, so a stale write cannot land after the rewrite
        self._writeback_done: Optional[threading.Event] = None
        # spill leaf by leaf: master (fp32 for floating leaves) and zero
        # moments; the whole fp32 tree is never host-resident
        self._meta: list = []   # per leaf: (shape, dtype, promoted)
        for i, leaf in enumerate(master_pieces):
            promote = leaf.is_floating_point()
            if promote:
                blk = chunked_device_get(
                    leaf, what="master spill",
                    out=torch.empty(leaf.shape, dtype=torch.float32))
                zeros = torch.zeros_like(blk)
                self._write_leaf(i, blk, zeros, zeros)
            else:
                blk = chunked_device_get(leaf, what="master spill")
                self._write_leaf(i, blk, None, None)
            self._meta.append((tuple(leaf.shape),
                               torch.float32 if promote else leaf.dtype,
                               promote))
            del blk
        #: master + moments on disk (exceeds the RAM budget by design)
        self.total_state_bytes = sum(
            (3 if prom else 1) * int(np.prod(shape, dtype=np.int64))
            * torch.empty(0, dtype=dt).element_size()
            for shape, dt, prom in self._meta)
        self._grad_bufs = [_pinned(s, torch.float32, self.device)
                           if prom else None for s, _, prom in self._meta]
        self._up_bufs = [_pinned(s, compute_dtype, self.device)
                         if prom else None for s, _, prom in self._meta]

    # -- stage plumbing -------------------------------------------------
    def bind_stages(self, read_stage: Stage, write_stage: Stage) -> None:
        """Adopt the engine's wired stage records (budgets that persist
        across steps, telemetry counters, flight-recorder dumps)."""
        self._read_stage = read_stage
        self._write_stage = write_stage

    def _drain_close_release(self, ch: Channel) -> None:
        """Clear a channel's queued items, close it and release their
        resident-byte claims, atomically."""
        with ch.cond:
            items = [it for it in ch.items if it is not _DONE]
            ch.items.clear()
            ch.closed = True
            ch.cond.notify_all()
        for it in items:
            # read items are (i, sections); write items (i, sections, n)
            self._release(self._state_bytes(it[1]) if len(it) == 2
                          else it[2])

    def abort_inflight(self) -> None:
        """Release the pipeline's workers without waiting (an engine close
        landing mid-step): the channels close and the step raises."""
        self._abort = True
        for ch in list(self._inflight):
            self._drain_close_release(ch)

    # -- residency accounting -------------------------------------------
    def _acquire(self, nbytes: int) -> None:
        with self._resident_lock:
            self._resident_bytes += nbytes
            claimed = self._resident_bytes
            over = (self.ram_budget_bytes is not None
                    and claimed > self.ram_budget_bytes)
            if over:
                self._resident_bytes -= nbytes
            elif claimed > self.peak_resident_bytes:
                self.peak_resident_bytes = claimed
        if over:
            raise RuntimeError(
                f"disk-tier resident state {claimed} bytes exceeds the "
                f"configured host-RAM budget {self.ram_budget_bytes} "
                f"(io_depth={self.io_depth}): the pipeline window no "
                "longer fits — lower io_depth or raise the budget")

    def _release(self, nbytes: int) -> None:
        with self._resident_lock:
            self._resident_bytes -= nbytes

    @staticmethod
    def _state_bytes(sections: Dict[str, torch.Tensor]) -> int:
        return sum(t.numel() * t.element_size() for t in sections.values())

    # -- file I/O units (one Stage.call each) ----------------------------
    def _write_leaf(self, i: int, master, mu, nu,
                    timings: Optional[list] = None) -> None:
        sections = {"master": master}
        if mu is not None:
            sections["mu"] = mu
            sections["nu"] = nu
        nbytes = self._state_bytes(sections)
        t0 = time.perf_counter()
        with _transfer_span("offload/disk_write", cat="disk", leaf=i,
                            bytes=nbytes):
            self._write_stage.call(
                "write", lambda: self._store.write(i, sections),
                path=self._store.path(i))
        if timings is not None:
            timings.append((t0, time.perf_counter(), nbytes))

    def _read_leaf(self, i: int, timings: Optional[list] = None,
                   names: Optional[Tuple[str, ...]] = None
                   ) -> Dict[str, torch.Tensor]:
        if names is None:
            names = _SECTIONS if self._meta[i][2] else ("master",)
        t0 = time.perf_counter()
        with _transfer_span("offload/disk_read", cat="disk", leaf=i):
            out = self._read_stage.call(
                "read", lambda: self._store.read(i, names=names),
                path=self._store.path(i))
        if timings is not None:
            timings.append((t0, time.perf_counter(),
                            self._state_bytes(out)))
        return out

    # -- the host tier's interface ----------------------------------------
    def _view(self, i: int, name: str) -> _DiskLeafView:
        shape, dt, _ = self._meta[i]
        return _DiskLeafView(self._store, i, name, shape, dt)

    @property
    def master(self) -> List[_DiskLeafView]:
        """Lazy master views: shape and dtype resident, bytes on disk."""
        return [self._view(i, "master") for i in range(len(self._meta))]

    @property
    def staged_bytes(self) -> int:
        """Bytes of the master and moments (on disk)."""
        return self.total_state_bytes

    def compute_params(self) -> List[torch.Tensor]:
        """The compute-dtype copies, read one master section at a time
        into the upload buffers (the moments are not read)."""
        out = []
        for i in range(len(self._meta)):
            blk = self._read_leaf(i, names=("master",))["master"]
            buf = self._up_bufs[i]
            out.append(blk if buf is None else buf.copy_(blk))
        return out

    def _require_healthy(self):
        if self._poisoned is not None:
            raise RuntimeError(
                "DiskOffloadOptimizer is poisoned: a previous step failed "
                "mid-update, leaving the on-disk master/moments "
                "inconsistent across leaves. Restore from a checkpoint. "
                f"Original error: {self._poisoned!r}")

    def step(self, grads: List[torch.Tensor],
             on_leaf: Optional[Callable] = None) -> List[torch.Tensor]:
        """The native Adam over disk-resident state; returns each leaf's
        compute-dtype host copy (``on_leaf(i, copy)`` fires as leaf i is
        done), the grads pulled as on the host tier.  A failure poisons:
        leaves before it hold step t, later ones t-1."""
        self._require_healthy()
        with self._resident_lock:
            if self._resident_bytes:
                logger.warning(
                    "disk-tier resident accounting reset: %d bytes "
                    "stranded by a previous failed step",
                    self._resident_bytes)
                self._resident_bytes = 0
        n = len(self._meta)
        assert len(grads) == n, (len(grads), n)
        serial = (self._read_stage.degraded or self._write_stage.degraded
                  or os.environ.get("DS_DISK_OFFLOAD_PIPELINE", "1")
                  == "0")
        if self.opt._lib is not None:
            self.opt._lib.omp_set_num_threads(self.opt.omp_threads)
        self.opt.step_count += 1
        lr = self.opt._lr_now()
        kind = lowp_kind(self.compute_dtype)
        read_t: list = []
        write_t: list = []
        adam_t: list = []
        puller = _PrefetchPuller(grads, self._grad_bufs, self._stream)
        self._abort = False
        run = self._step_serial if serial else self._step_pipelined
        try:
            outs = run(grads, puller, lr, kind, on_leaf, read_t, write_t,
                       adam_t)
        except BaseException as e:
            self._poisoned = e
            raise
        finally:
            puller.close()
            if puller.bytes:
                self.last_d2h_seconds = puller.seconds
                self.last_d2h_bytes = puller.bytes
            self._record_breakdown(read_t, write_t, adam_t, serial)
        return outs

    def _update_one(self, i, state, g, puller, lr, kind, adam_t):
        """Adam over one leaf's freshly read state (``apply_leaf``, the
        host tier's call); returns (upload copy, updated sections or None
        for a passthrough leaf)."""
        p = state["master"]
        if not self._meta[i][2]:
            return p, None
        t0 = time.perf_counter()
        with _transfer_span("offload/adam_leaf", cat="offload", leaf=i):
            buf = self._up_bufs[i]
            self.opt.apply_leaf(p, puller(i, g), state["mu"], state["nu"],
                                lr, kind, buf if kind else None)
        adam_t.append((t0, time.perf_counter()))
        return (buf if kind else buf.copy_(p)), state

    def _step_serial(self, grads, puller, lr, kind, on_leaf, read_t,
                     write_t, adam_t):
        """The degradation target and bitwise reference: read leaf i,
        update, write it back, then leaf i+1 — no workers."""
        outs: list = [None] * len(self._meta)
        for i, g in enumerate(grads):
            state = self._read_leaf(i, read_t)
            nbytes = self._state_bytes(state)
            self._acquire(nbytes)
            try:
                up, updated = self._update_one(i, state, g, puller, lr,
                                               kind, adam_t)
                if updated is not None:
                    self._write_leaf(i, updated["master"], updated["mu"],
                                     updated["nu"], write_t)
            finally:
                self._release(nbytes)
            outs[i] = up
            if on_leaf is not None:
                on_leaf(i, up)
        return outs

    def _step_pipelined(self, grads, puller, lr, kind, on_leaf, read_t,
                        write_t, adam_t):
        """A read-ahead worker keeps at most ``io_depth`` leaf states
        staged, this thread updates them in order, a write-back worker
        drains at most ``io_depth`` updated states to disk."""
        n = len(self._meta)
        rd_ch = Channel(capacity=self.io_depth)
        wr_ch = Channel(capacity=self.io_depth)
        self._inflight = [rd_ch, wr_ch]
        wr_done = threading.Event()
        self._writeback_done = wr_done
        wr_err: dict = {}

        def read_loop():
            try:
                for i in range(n):
                    if self._abort:
                        rd_ch.close()
                        return
                    state = self._read_leaf(i, read_t)
                    self._acquire(self._state_bytes(state))
                    if not rd_ch.put((i, state)):
                        self._release(self._state_bytes(state))
                        return
                rd_ch.put(_DONE, force=True)
            except BaseException as e:
                rd_ch.poison(e)

        def write_loop():
            try:
                while True:
                    item = wr_ch.get()
                    if item is _DONE:
                        break
                    i, st, nbytes = item
                    try:
                        self._write_leaf(i, st["master"], st["mu"],
                                         st["nu"], write_t)
                    finally:
                        self._release(nbytes)
            except BaseException as e:
                wr_err["e"] = e
                wr_ch.poison(e)
            finally:
                wr_done.set()

        spawn(read_loop, name="ds-disk-read", restarts=0)
        spawn(write_loop, name="ds-disk-write", restarts=0)
        outs: list = [None] * n
        try:
            for i, g in enumerate(grads):
                item = rd_ch.get()   # re-raises the reader's failure
                assert item is not _DONE and item[0] == i, (i, item)
                state = item[1]
                nbytes = self._state_bytes(state)
                try:
                    up, updated = self._update_one(i, state, g, puller, lr,
                                                   kind, adam_t)
                except BaseException:
                    self._release(nbytes)
                    raise
                if updated is not None:
                    # bounded backpressure: this thread stalls when the
                    # writer falls behind (the tier's RAM ceiling)
                    if not wr_ch.put((i, updated, nbytes)):
                        self._release(nbytes)
                        raise wr_err.get("e") or RuntimeError(
                            "disk write-back channel closed mid-step")
                else:
                    self._release(nbytes)
                outs[i] = up
                if on_leaf is not None:
                    on_leaf(i, up)
            wr_ch.put(_DONE, force=True)
            wr_done.wait()
            if "e" in wr_err:
                raise wr_err["e"]
        except BaseException:
            self._drain_close_release(rd_ch)
            self._drain_close_release(wr_ch)
            wr_done.wait(timeout=30.0)
            raise
        finally:
            self._inflight = []
        return outs

    def _record_breakdown(self, read_t, write_t, adam_t, serial):
        """How much disk I/O time ran under the Adam (host stamps): each
        I/O interval intersected with the merged Adam intervals (zero on
        the serial loop by construction)."""
        read_t, write_t, adam_t = list(read_t), list(write_t), list(adam_t)
        merged: list = []
        for a0, a1 in sorted(adam_t):
            if merged and a0 <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], a1))
            else:
                merged.append((a0, a1))

        def hidden_of(t0, t1):
            return sum(max(0.0, min(t1, a1) - max(t0, a0))
                       for a0, a1 in merged)

        read_s = sum(t1 - t0 for t0, t1, _ in read_t)
        write_s = sum(t1 - t0 for t0, t1, _ in write_t)
        hidden = sum(hidden_of(t0, t1) for t0, t1, _ in read_t + write_t)
        io_s = read_s + write_s
        self.last_disk_breakdown = {
            "tier": "disk",
            "disk_serial": bool(serial),
            "disk_read_s": read_s,
            "disk_write_s": write_s,
            "disk_hidden_s": hidden,
            "disk_overlap_ratio": (hidden / io_s) if io_s > 0 else 0.0,
            "disk_bytes_read": sum(b for _, _, b in read_t),
            "disk_bytes_written": sum(b for _, _, b in write_t),
        }

    # -- checkpoint plumbing ---------------------------------------------
    def state_tree(self):
        """``{"step", "mu", "nu"}`` as lazy disk views (zeros of its own
        dtype for a passthrough leaf); refuses while poisoned."""
        if self._poisoned is not None:
            raise RuntimeError(
                "refusing to serialize inconsistent optimizer state (a "
                "step failed mid-update on the disk tier). Restore from "
                f"an earlier checkpoint. Original error: "
                f"{self._poisoned!r}")

        def views(name):
            return [self._view(i, name) if prom
                    else torch.zeros(shape, dtype=dt)
                    for i, (shape, dt, prom) in enumerate(self._meta)]

        return {"step": self.opt.step_count, "mu": views("mu"),
                "nu": views("nu")}

    def load_state_tree(self, master, step: int, mu=None, nu=None) -> None:
        """Restore by rewriting every leaf file from the loaded leaves
        (``mu`` None: zero moments) — which also heals a torn write-back;
        clears the poison."""
        ev = self._writeback_done
        if ev is not None and not ev.wait(timeout=60.0):
            raise RuntimeError(
                "disk write-back worker from a failed step is still in "
                "flight after 60s; refusing to restore over it")

        def host(x, dtype):
            t = x.materialize() if hasattr(x, "materialize") else x
            t = t if isinstance(t, torch.Tensor) else torch.as_tensor(
                np.asarray(t))
            return t.detach().to("cpu", dtype).contiguous()

        for i, (shape, dt, promote) in enumerate(self._meta):
            blk = host(master[i], dt)
            assert tuple(blk.shape) == shape, (blk.shape, shape)
            if not promote:
                self._write_leaf(i, blk, None, None)
                continue
            if mu is None:
                m = torch.zeros(shape, dtype=torch.float32)
                v = torch.zeros_like(m)
            else:
                m, v = host(mu[i], torch.float32), host(nu[i], torch.float32)
            self._write_leaf(i, blk, m, v)
        self.opt.step_count = int(step)
        self._poisoned = None
