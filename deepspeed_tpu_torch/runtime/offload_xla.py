"""ZeRO-Offload's XLA tier as pinned host pieces — the port of the JAX
engine's ``offload_impl: "xla"`` (``deepspeed_tpu/runtime/engine.py``:
``_FlatLeaf`` and its pack/unpack pair, ``_offload_update_scalars``,
``_build_xla_offload_step``, ``_host_adam_pieces``, the chunked-gradient
steps, the split update and the delayed update) and of GPT-2's
``stream_scan`` parameter streaming.

On a TPU the JAX tier keeps the fp32 master and the Adam moments in
``pinned_host`` memory, one partition-major ``(dp, w_i)`` piece per leaf,
and XLA schedules the transfers inside one compiled step.  Here each
rank keeps ITS row of every piece (master, mu, nu: ``w_i`` fp32 each) in
page-locked host tensors (:class:`PinnedPieces`), and the update runs on
the card piece by piece in chunks of at most 64 MiB of fp32:

  H2D   the chunk's three state rows (and a host-resident gradient) into
        a double-buffered device ring on a side stream;
  math  the JAX tier's ``_host_adam_pieces`` on the compute stream: the
        clip scale, the weight-decay arms, the moments, the direction and
        the overflow skip as a select on ``finite`` (a device bool: the
        step never reads a value back); the compute copy cast from the
        updated master;
  D2H   the updated rows back into the pinned pieces on a second side
        stream; the ring slot is reused only after its D2H event.

That is the JAX engine's ``DS_OFFLOAD_COMPUTE_ON=0`` arm (the optimizer
math on the device, the state streamed from host memory), and the only
arm here: torch has no host-compute region, so the environment knob has
no counterpart.  Every transfer buffer is pinned (a ``non_blocking``
copy into pageable memory would run synchronously) and every device
tensor a side stream touches is ``record_stream``-ed on it.

Layout (``FlatLeaf``): a leaf ZeRO shards over ``data`` (the stage's
``zero_dim``, dp > 1) has that dim moved to the front, so rank r's row is
exactly its data shard; any other leaf is flattened, padded to a multiple
of dp and row-chunked.  Packing a rank's gradient into its row and
unpacking its row into its stage-3 shard are therefore local: no
collective.  At stages <= 2 each updated compute row is all-gathered over
``data`` once per piece; at stage 3 the compute copy stays data-sharded
and ``runtime/zero.py``'s fetch gathers it per block.

Modes (``zero_optimization``):
  ``offload_grad_chunks`` K > 1 — K balanced leaf groups, each its own
        forward and backward on the same step seed (the hash dropout
        draws the same masks), only that group's gradients kept, packed
        to compute-dtype rows and moved to pinned host rows; the finite
        flags and the per-leaf sums of squares combine across groups
        before the clip and the update.  Device gradient bytes are bounded
        by the largest group.
  ``offload_split_update`` (or ``DS_OFFLOAD_SPLIT_UPDATE=1``) — the
        update writes each piece in place; a failure part-way (a
        KeyboardInterrupt included) poisons the engine until
        ``load_checkpoint``.  Without it the update writes a second set of
        pinned pieces and swaps them in at the end, so a failure leaves
        the state whole (twice the host bytes).
  ``delayed_param_update`` — step t's gradients are computed on the
        stale master before step t-1's update; an overflow at t-1 applies
        the pending update first (one skip per overflow); the step seed
        comes from a host dispatch counter, restored from
        ``global_steps`` on load; a save and an eval flush the pending
        update.
  ``param_streaming`` (GPT-2 with ``stream_scan``) — the compute copies
        of the stacked ``blocks/*`` leaves stay in pinned host memory
        (:class:`StreamedLeaves`): each block fetches its layer's slice on
        a side stream with the next layer's prefetched under it (at stage
        3 the owner's slice, then the broadcast), the checkpointed
        backward fetches it again, and each layer's gradient goes to a
        pinned host stack, accumulated there over the micro-batches.
        Device parameter bytes are about one layer plus the embeddings.

Checkpoints keep the canonical ``FusedAdamState(count, mu, nu)`` tree
(``_canonical_state``), so they cross between this tier, the host and
disk tiers, plain engines and the JAX package, across a dp resize.
"""
from __future__ import annotations

import os
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.adam import FusedAdamState
from ..parallel import collectives as col
from ..parallel.mesh import DATA_AXIS
from ..utils.logging import logger
from .offload import _pinned, chunked_device_get
from .utils import fold_in, tree_leaves


# ---------------------------------------------------------------------------
# the piece layout (reference engine.py:92-150)
# ---------------------------------------------------------------------------
class FlatLeaf(NamedTuple):
    """One leaf's record in the partition-major layout: ``data_dim`` is
    the dim ZeRO shards over ``data`` (moved to the front before
    flattening), None for a leaf padded to a multiple of dp and
    row-chunked; ``w`` is a rank's row width."""
    shape: tuple
    size: int
    data_dim: Optional[int]
    w: int
    pad: int


def flat_leaf_layout(shape: tuple, data_dim: Optional[int],
                     dp: int) -> FlatLeaf:
    size = int(np.prod(shape, dtype=np.int64)) if shape else 1
    if dp > 1 and data_dim is not None and shape[data_dim] % dp == 0:
        return FlatLeaf(tuple(shape), size, data_dim, size // dp, 0)
    pad = (-size) % dp
    return FlatLeaf(tuple(shape), size, None, (size + pad) // dp, pad)


def _is_torch(x) -> bool:
    return isinstance(x, torch.Tensor)


def _moveaxis(x, a: int, b: int):
    return x.movedim(a, b) if _is_torch(x) else np.moveaxis(x, a, b)


def pack_leaf(x, rec: FlatLeaf, dp: int):
    """A whole leaf -> its ``(dp, w)`` piece (torch or numpy: one
    implementation, so the device layout and the checkpoint layout
    cannot drift)."""
    if rec.data_dim is not None:
        return _moveaxis(x, rec.data_dim, 0).reshape(dp, rec.w)
    v = x.reshape(-1)
    if rec.pad:
        if _is_torch(v):
            v = torch.cat([v, v.new_zeros(rec.pad)])
        else:
            v = np.concatenate([v, np.zeros((rec.pad,), v.dtype)])
    return v.reshape(dp, rec.w)


def unpack_leaf(piece, rec: FlatLeaf):
    """Inverse of :func:`pack_leaf`: a ``(dp, w)`` piece -> the leaf."""
    if rec.data_dim is not None:
        moved = ((rec.shape[rec.data_dim],)
                 + tuple(d for i, d in enumerate(rec.shape)
                         if i != rec.data_dim))
        return _moveaxis(piece.reshape(moved), 0, rec.data_dim)
    return piece.reshape(-1)[:rec.size].reshape(rec.shape)


def pack_row(x: torch.Tensor, rec: FlatLeaf, dp: int,
             rank: int) -> torch.Tensor:
    """This rank's row from its master-placed piece of the leaf: the
    data shard (``data_dim``) or the whole leaf (padded rows) — local
    either way."""
    if rec.data_dim is not None:
        return x.movedim(rec.data_dim, 0).reshape(-1)
    v = x.reshape(-1)
    lo, hi = rank * rec.w, (rank + 1) * rec.w
    if hi <= rec.size:
        return v[lo:hi]
    row = v.new_zeros(rec.w)
    if lo < rec.size:
        row[:rec.size - lo] = v[lo:]
    return row


def unpack_row(row: torch.Tensor, rec: FlatLeaf, dp: int) -> torch.Tensor:
    """This rank's data shard of a ``data_dim`` leaf from its row (the
    stage-3 source; local)."""
    d = rec.data_dim
    moved = ((rec.shape[d] // dp,)
             + tuple(n for i, n in enumerate(rec.shape) if i != d))
    return row.reshape(moved).movedim(0, d)


def grad_group_indices(sizes: List[int], k: int) -> List[List[int]]:
    """Balanced greedy partition of leaf indices into ``k`` groups
    (reference ``_grad_group_indices``)."""
    order = sorted(range(len(sizes)), key=lambda i: -sizes[i])
    groups: List[List[int]] = [[] for _ in range(k)]
    loads = [0] * k
    for i in order:
        g = loads.index(min(loads))
        groups[g].append(i)
        loads[g] += sizes[i]
    return [sorted(g) for g in groups if g]


def offload_update_scalars(count, grad_norm, *, b1, b2, bias_correction,
                           clip, lr_at):
    """The update's scalars (reference ``_offload_update_scalars``): the
    bias corrections and the lr at the next count, and the clip factor
    from the global norm — device tensors, nothing read back."""
    count1 = count + 1
    if bias_correction:
        c = count1.float()
        c1, c2 = 1 - b1 ** c, 1 - b2 ** c
    else:
        c1 = c2 = torch.ones((), dtype=torch.float32, device=count.device)
    cscale = (torch.clamp(clip / (grad_norm + 1e-6), max=1.0)
              if clip > 0 else None)
    return c1, c2, lr_at(count1).reshape(()), cscale


class AdamHyper(NamedTuple):
    b1: float
    b2: float
    eps: float
    wd: float
    adamw: bool


class HostGrad:
    """A gradient accumulated in pinned host memory (a streamed leaf's
    stack): ``acc`` holds the loss-scaled sum, ``inv`` the device scalar
    that unscales it (applied on the card as its chunks come up)."""

    __slots__ = ("acc", "inv")

    def __init__(self, acc: torch.Tensor, inv=None):
        self.acc, self.inv = acc, inv


def _cuda_stream(device):
    return torch.cuda.Stream(device) if device.type == "cuda" else None


# ---------------------------------------------------------------------------
# the pinned pieces and the device update
# ---------------------------------------------------------------------------
class PinnedPieces:
    """One rank's rows of the master and both moments, pinned, and the
    update that streams them through a device ring (module docstring).
    ``count`` is the device count of applied updates."""

    def __init__(self, rows: List[torch.Tensor], device: torch.device,
                 compute_dtype: torch.dtype, chunk_bytes: int = 64 << 20):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.compute_dtype = compute_dtype

        def pinned(n):
            return _pinned((n,), torch.float32, self.device)

        self.master = []
        for r in rows:
            self.master.append(chunked_device_get(
                r.detach(), what="master pull", out=pinned(r.numel())))
        self.mu = [pinned(r.numel()).zero_() for r in rows]
        self.nu = [pinned(r.numel()).zero_() for r in rows]
        self.count = torch.zeros((), dtype=torch.int32, device=self.device)
        self._spare = None
        #: fp32 elements of a ring slot's buffers
        self._chunk = max(1, chunk_bytes // 4)
        self._h2d = _cuda_stream(self.device)
        self._d2h = _cuda_stream(self.device)
        self._ring = None
        self._free = [None, None]
        self.last_stats = None
        self._timing = None

    @property
    def nbytes(self) -> int:
        """Pinned host bytes of the master and moments (a spare set, when
        the fused update made one, doubles them)."""
        one = 3 * sum(m.numel() * 4 for m in self.master)
        return one * (2 if self._spare is not None else 1)

    def sync(self) -> None:
        """Wait for every D2H write into the pinned pieces (before the
        host reads them)."""
        if self._d2h is not None:
            self._d2h.synchronize()

    def d2h_event(self):
        """An event after every D2H write enqueued so far (a reader on
        another stream waits on it), None off CUDA."""
        if self._d2h is None:
            return None
        ev = torch.cuda.Event()
        ev.record(self._d2h)
        return ev

    def load(self, rows_master, rows_mu, rows_nu, count: int) -> None:
        """Copy restored rows in place (the pieces keep their identity)."""
        self.sync()
        for dst, src in ((self.master, rows_master), (self.mu, rows_mu),
                         (self.nu, rows_nu)):
            for d, s in zip(dst, src):
                if s is None:
                    d.zero_()
                else:
                    d.copy_(s.reshape(-1))
        self.count = torch.full((), int(count), dtype=torch.int32,
                                device=self.device)

    # -- the math (reference _host_adam_pieces) --------------------------
    @staticmethod
    def piece_math(m, mu, nu, g32, finite, c1, c2, lr, cs,
                   hp: AdamHyper) -> None:
        """One chunk's Adam in place on fp32 tensors, kept only where
        ``finite``: the one definition of the clip, weight-decay and
        overflow-skip semantics for every arm."""
        if cs is not None:
            g32 = g32 * cs
        if hp.wd != 0.0 and not hp.adamw:
            g32 = g32 + hp.wd * m
        mu2 = hp.b1 * mu + (1 - hp.b1) * g32
        nu2 = hp.b2 * nu + (1 - hp.b2) * (g32 * g32)
        upd = (mu2 / c1) / (torch.sqrt(nu2 / c2) + hp.eps)
        if hp.wd != 0.0 and hp.adamw:
            upd = upd + hp.wd * m
        m2 = m - lr * upd
        m.copy_(torch.where(finite, m2, m))
        mu.copy_(torch.where(finite, mu2, mu))
        nu.copy_(torch.where(finite, nu2, nu))

    def _grad32(self, g, inv, cdt):
        """A gradient chunk as the update's fp32 input: a compute-dtype
        chunk widened; a host-accumulated fp32 chunk unscaled and rounded
        to the compute dtype first (the pack's rounding)."""
        if inv is None:
            return g.float()
        return (g.float() * inv).to(cdt).float()

    def _ring_for(self, n: int):
        if self._ring is None:
            c = min(self._chunk, max(n, 1))
            mk = lambda dt: [torch.empty(c, dtype=dt,  # noqa: E731
                                         device=self.device)
                             for _ in range(2)]
            self._ring = {"m": mk(torch.float32), "mu": mk(torch.float32),
                          "nu": mk(torch.float32), "g": mk(torch.float32),
                          "lp": mk(self.compute_dtype), "cap": c}
        return self._ring

    def update(self, grads, finite, c1, c2, lr, cs, hp: AdamHyper,
               sinks=None, in_place: bool = True, on_piece=None,
               timing: bool = False, ready=None):
        """Update every piece.  ``grads[i]``: ``(row, inv)`` — a device
        compute-dtype row (``inv`` None), a pinned compute-dtype row, or a
        pinned fp32 host stack row with its unscale ``inv``.  ``sinks[i]``:
        a pinned host tensor that receives the compute-dtype row, else a
        device row is returned.  ``in_place`` writes the pieces
        themselves; otherwise a second set, swapped in after the last
        piece (a failure leaves the state whole).  ``on_piece(i, row)``
        fires as piece i's compute row is written; ``ready``: an event
        the H2D waits on (the host gradient rows' D2H).  The H2D does not
        wait for the compute stream, so under the delayed update it runs
        beside the next step's backward.  Returns the device rows (None
        where a sink took it)."""
        n = len(self.master)
        sinks = sinks or [None] * n
        if in_place:
            dst = (self.master, self.mu, self.nu)
        else:
            if self._spare is None:
                # pinned like the pieces (``empty_like`` would not pin:
                # a D2H into pageable memory runs synchronously)
                self._spare = tuple(
                    [_pinned(t.shape, t.dtype, self.device) for t in ts]
                    for ts in (self.master, self.mu, self.nu))
            dst = self._spare
        src = (self.master, self.mu, self.nu)
        cdt = self.compute_dtype
        outs: List[Optional[torch.Tensor]] = [None] * n
        if not self.cuda:
            for i in range(n):
                m, mu, nu = (d[i] for d in dst)
                if not in_place:
                    for d, s in zip((m, mu, nu), src):
                        d.copy_(s[i])
                g, inv = grads[i]
                self.piece_math(m, mu, nu, self._grad32(g, inv, cdt),
                                finite, c1, c2, lr, cs, hp)
                row = m.to(cdt)
                if sinks[i] is not None:
                    sinks[i].copy_(row)
                else:
                    outs[i] = row
                if on_piece is not None:
                    on_piece(i, outs[i])
        else:
            outs = self._update_cuda(grads, finite, c1, c2, lr, cs, hp,
                                     sinks, src, dst, on_piece, timing,
                                     ready)
        if not in_place:
            self.master, self.mu, self.nu = (list(d) for d in dst)
            self._spare = tuple(list(s) for s in src)
        return outs

    def _update_cuda(self, grads, finite, c1, c2, lr, cs, hp, sinks, src,
                     dst, on_piece, timing, ready):
        main = torch.cuda.current_stream(self.device)
        h2d, d2h = self._h2d, self._d2h
        cap = self._ring_for(max(m.numel() for m in self.master))["cap"]
        ring = self._ring
        cdt = self.compute_dtype
        if ready is not None:
            h2d.wait_event(ready)
        t = None
        if timing:
            t = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            t[0].record(h2d)
        h2d_bytes = d2h_bytes = 0
        outs: List[Optional[torch.Tensor]] = [None] * len(self.master)
        k = 0
        for i in range(len(self.master)):
            w = self.master[i].numel()
            g, inv = grads[i]
            row = None
            if sinks[i] is None:
                row = torch.empty(w, dtype=cdt, device=self.device)
            for s in range(0, w, cap):
                e = min(w, s + cap)
                n = e - s
                slot = k % 2
                k += 1
                bm, bmu, bnu = (ring[x][slot][:n] for x in ("m", "mu", "nu"))
                ev_free = self._free[slot]
                if ev_free is not None:
                    h2d.wait_event(ev_free)
                with torch.cuda.stream(h2d):
                    for b, host in ((bm, src[0][i]), (bmu, src[1][i]),
                                    (bnu, src[2][i])):
                        b.copy_(host[s:e], non_blocking=True)
                        b.record_stream(h2d)
                    h2d_bytes += 12 * n
                    if g.is_cuda:
                        gc = g[s:e]
                    else:
                        gc = ring["g"][slot].view(g.dtype)[:n]
                        gc.copy_(g[s:e], non_blocking=True)
                        gc.record_stream(h2d)
                        h2d_bytes += n * g.element_size()
                    ev_in = torch.cuda.Event()
                    ev_in.record(h2d)
                main.wait_event(ev_in)
                self.piece_math(bm, bmu, bnu, self._grad32(gc, inv, cdt),
                                finite, c1, c2, lr, cs, hp)
                if row is not None:
                    row[s:e].copy_(bm)
                else:
                    lp = ring["lp"][slot][:n]
                    lp.copy_(bm)
                ev_c = torch.cuda.Event()
                ev_c.record(main)
                d2h.wait_event(ev_c)
                with torch.cuda.stream(d2h):
                    for b, host in ((bm, dst[0][i]), (bmu, dst[1][i]),
                                    (bnu, dst[2][i])):
                        host[s:e].copy_(b, non_blocking=True)
                        b.record_stream(d2h)
                    d2h_bytes += 12 * n
                    if row is None:
                        sinks[i].view(-1)[s:e].copy_(lp, non_blocking=True)
                        lp.record_stream(d2h)
                        d2h_bytes += n * lp.element_size()
                    ev = torch.cuda.Event()
                    ev.record(d2h)
                self._free[slot] = ev
            outs[i] = row
            if on_piece is not None:
                on_piece(i, row)
        if t is not None:
            t[1].record(h2d)
            t[2].record(d2h)
            self._timing = (t, h2d_bytes, d2h_bytes)
        # the next update's H2D reads what this one's D2H wrote
        h2d.wait_stream(d2h)
        return outs

    def transfer_stats(self) -> Optional[dict]:
        """The last timed update's bytes and device-time windows: the H2D
        stream from its first copy to its last (``h2d_s``; it also waits
        for free ring slots) and to the D2H stream's last (``window_s``,
        the whole update): synchronizes on them."""
        if self._timing is None:
            return self.last_stats
        t, hb, db = self._timing
        t[2].synchronize()
        t[1].synchronize()
        self.last_stats = {
            "h2d_bytes": hb, "d2h_bytes": db,
            "h2d_s": t[0].elapsed_time(t[1]) / 1e3,
            "window_s": t[0].elapsed_time(t[2]) / 1e3}
        self._timing = None
        return self.last_stats


# ---------------------------------------------------------------------------
# parameter streaming: host-resident compute copies, one layer per block
# ---------------------------------------------------------------------------
class StreamedLeaves:
    """The compute copies of the streamed (stacked) leaves in pinned host
    memory, fetched one layer at a time on a side stream with the next
    layer prefetched under the current one's compute, and their
    gradients taken to pinned fp32 host stacks (the first contribution
    copied, later micro-batches staged and added on the host).  With the
    delayed update two stacks alternate by step, so a pending update's
    gradients are never overwritten."""

    def __init__(self, leaves: Dict[int, torch.Tensor], device,
                 double_buffer: bool = False):
        self.leaves = leaves            # leaf index -> pinned cdt stack
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self._fetch_stream = _cuda_stream(self.device)
        self._d2h = _cuda_stream(self.device)
        self._cache: Dict[Tuple[int, int], tuple] = {}
        self._last: Dict[int, int] = {}
        self._ready = None
        self._sets = [{i: _pinned(t.shape, torch.float32, self.device)
                       for i, t in leaves.items()}]
        if double_buffer:
            self._sets.append({i: _pinned(t.shape, torch.float32,
                                          self.device)
                               for i, t in leaves.items()})
        self._cur = 0
        self.acc = self._sets[0]
        self._keep = None
        self._touched: set = set()
        self._pending: list = []
        self._staging: Dict[tuple, list] = {}
        self.fetched_bytes = 0
        #: None, or a list that collects (start, end, bytes) per fetch
        self.fetch_timing: Optional[list] = None

    @property
    def nbytes(self) -> int:
        """Pinned host bytes: the compute copies and the gradient
        stacks."""
        return (sum(t.numel() * t.element_size()
                    for t in self.leaves.values())
                + sum(t.numel() * 4 for s in self._sets for t in s.values()))

    def invalidate(self, ready_event=None) -> None:
        """The host copies changed (an update or a load): drop prefetched
        layers; later fetches wait on ``ready_event`` (the D2H writes)."""
        self._cache.clear()
        self._last.clear()
        self._ready = ready_event

    # -- the fetch ---------------------------------------------------------
    def _issue(self, i: int, idx: int):
        src = self.leaves[i][idx]
        if not self.cuda:
            return src.clone(), None
        fs = self._fetch_stream
        timed = self.fetch_timing is not None
        with torch.cuda.stream(fs):
            if self._ready is not None:
                fs.wait_event(self._ready)
            dst = torch.empty(src.shape, dtype=src.dtype,
                              device=self.device)
            if timed:
                t0 = torch.cuda.Event(enable_timing=True)
                t0.record(fs)
            dst.copy_(src, non_blocking=True)
            ev = torch.cuda.Event(enable_timing=timed)
            ev.record(fs)
        nbytes = dst.numel() * dst.element_size()
        self.fetched_bytes += nbytes
        if timed:
            self.fetch_timing.append((t0, ev, nbytes))
        return dst, ev

    def fetch_stats(self) -> Optional[dict]:
        """Bytes and device seconds of the timed fetches
        (``fetch_timing = []`` turns the timing on; synchronizes)."""
        if not self.fetch_timing:
            return None
        self.fetch_timing[-1][1].synchronize()
        secs = sum(a.elapsed_time(b) for a, b, _ in self.fetch_timing) / 1e3
        nbytes = sum(n for *_, n in self.fetch_timing)
        self.fetch_timing = []
        return {"bytes": nbytes, "seconds": secs}

    def getter(self, i: int):
        def get(idx):
            return self.fetch(i, idx)
        return get

    def fetch(self, i: int, idx: int) -> torch.Tensor:
        """Layer ``idx`` of streamed leaf ``i`` on the card; the next
        layer in the walk's direction starts copying under it."""
        hit = self._cache.pop((i, idx), None)
        dst, ev = hit if hit is not None else self._issue(i, idx)
        if ev is not None:
            main = torch.cuda.current_stream(self.device)
            main.wait_event(ev)
            dst.record_stream(main)
        last = self._last.get(i)
        step = -1 if last is not None and idx < last else 1
        self._last[i] = idx
        nxt = idx + step
        if 0 <= nxt < self.leaves[i].shape[0] \
                and (i, nxt) not in self._cache:
            self._cache[(i, nxt)] = self._issue(i, nxt)
        return dst

    # -- the gradient sink -------------------------------------------------
    def begin_step(self) -> None:
        """A new step's stacks (alternating under the delayed update)."""
        self._cur = (self._cur + 1) % len(self._sets)
        self.acc = self._sets[self._cur]

    def start_grads(self, keep) -> None:
        self._keep = keep
        self._touched = set()

    def _kept(self):
        return [i for i in self.leaves
                if self._keep is None or i in self._keep]

    def accumulate(self, i: int, idx: int, g32: torch.Tensor) -> None:
        """Add one layer's (reduced) fp32 gradient into the host stack."""
        target = self.acc[i][idx]
        first = (i, idx) not in self._touched
        self._touched.add((i, idx))
        if not self.cuda:
            if first:
                target.copy_(g32)
            else:
                target.add_(g32)
            return
        d2h = self._d2h
        d2h.wait_stream(torch.cuda.current_stream(self.device))
        if first:
            with torch.cuda.stream(d2h):
                target.copy_(g32, non_blocking=True)
                g32.record_stream(d2h)
            return
        ring = self._staging.setdefault(tuple(g32.shape), [])
        if len(ring) < 2:
            buf = _pinned(g32.shape, torch.float32, self.device)
        else:
            buf = ring.pop(0)
            self._drain(buf)
        with torch.cuda.stream(d2h):
            buf.copy_(g32, non_blocking=True)
            g32.record_stream(d2h)
            ev = torch.cuda.Event()
            ev.record(d2h)
        self._pending.append((ev, buf, target))
        ring.append(buf)

    def _drain(self, buf=None) -> None:
        keep = []
        for ev, b, target in self._pending:
            if buf is None or b is buf:
                ev.synchronize()
                target.add_(b)
            else:
                keep.append((ev, b, target))
        self._pending = keep

    def finish_grads(self) -> Dict[int, HostGrad]:
        """Every pending copy and add done; layers no micro-batch
        reached are zeroed.  Returns the kept leaves' stacks."""
        if self._d2h is not None:
            self._d2h.synchronize()
        self._drain()
        out = {}
        for i in self._kept():
            acc = self.acc[i]
            for idx in range(acc.shape[0]):
                if (i, idx) not in self._touched:
                    acc[idx].zero_()
            out[i] = HostGrad(acc)
        self._keep = None
        return out


# ---------------------------------------------------------------------------
# the engine's side (mixed into DeepSpeedEngine)
# ---------------------------------------------------------------------------
class XlaOffloadTier:
    """The XLA tier's init, step, delayed update, checkpoint conversion
    and poison, as methods of the training engine."""

    def _init_xla_offload(self, config, pieces) -> None:
        zc = config.zero_config
        rt = self._zero
        if not all(p.is_floating_point() for p in pieces):
            raise ValueError(
                "cpu_offload (xla tier) requires an all-float parameter "
                "tree; non-float leaves cannot be Adam-updated")
        dp, rank = self.dp_world_size, rt.dp_rank
        self._flat_layout = [
            flat_leaf_layout(pl.shape if rt.tp == 1 else tuple(
                b - a for a, b in rt.box(i, False)),
                pl.zero_dim if dp > 1 else None, dp)
            for i, pl in enumerate(rt.placements)]
        self._flat_sizes = [int(np.prod(pl.shape, dtype=np.int64))
                            for pl in rt.placements]
        # streaming: the model's mask over the stacked leaves
        self._stream_mask = [False] * len(pieces)
        if zc.param_streaming:
            if dp > 1 and config.zero_optimization_stage < 3:
                raise ValueError(
                    "param_streaming with dp > 1 requires ZeRO-3 (stage "
                    "<= 2 would need host-side all-gathers of the "
                    "streamed leaves; stage 3 keeps them data-sharded "
                    "end to end)")
            spec_fn = getattr(self.module, "streaming_param_spec", None)
            spec = (spec_fn(rt.template) if spec_fn is not None else None)
            if spec is None:
                raise ValueError(
                    "param_streaming is enabled but the model's "
                    "streaming_param_spec returned None — the model must "
                    "mark its stacked scan leaves (for GPT2Model set "
                    "scan_layers=True and stream_scan=True)")
            mask = tree_leaves(spec)
            if len(mask) != len(pieces):
                raise ValueError(
                    "streaming_param_spec structure does not match the "
                    f"parameter tree ({len(mask)} vs {len(pieces)} leaves)")
            self._stream_mask = [bool(b) for b in mask]
            if not any(self._stream_mask):
                raise ValueError("param_streaming is enabled but the model "
                                 "marked no leaves as streamable")
        rows = [pack_row(p.float(), rec, dp, rank)
                for p, rec in zip(pieces, self._flat_layout)]
        self._xla = PinnedPieces(rows, self.device, self.compute_dtype)
        del rows
        op = dict(config.optimizer_params)
        b1, b2 = (float(b) for b in op.get("betas", (0.9, 0.999)))
        self._xla_hyper = AdamHyper(
            b1, b2, float(op.get("eps", 1e-8)),
            float(op.get("weight_decay", 0.0)),
            bool(op.get("adam_w_mode", True)))
        self._xla_bias_correction = bool(op.get("bias_correction", True))
        chunks = min(max(int(zc.offload_grad_chunks or 1), 1), len(pieces))
        self._xla_groups = grad_group_indices(self._flat_sizes, chunks)
        self._xla_chunked = len(self._xla_groups) > 1
        self._xla_split = bool(zc.offload_split_update or os.environ.get(
            "DS_OFFLOAD_SPLIT_UPDATE") == "1")
        self._xla_dpu = bool(zc.delayed_param_update)
        self._xla_dpu_pending = None
        self._xla_dpu_dispatch = 0
        self._fatal_state_error = None
        self._xla_grad_sets = None
        if getattr(zc, "offload_pipeline_explicit", False) \
                and zc.offload_pipeline:
            logger.warning(
                "offload_pipeline is a host-tier knob; offload_impl is "
                "'xla', whose update streams its pieces through the "
                "device ring — the flag is ignored.")
        streamed = {}
        for i, on in enumerate(self._stream_mask):
            if on:
                shape = pieces[i].shape
                streamed[i] = _pinned(shape, self.compute_dtype,
                                      self.device)
        # a streamed leaf's source is its pinned host copy
        rt.sources = [streamed.get(i) for i in range(len(pieces))]
        if streamed:
            rt.streamer = StreamedLeaves(streamed, self.device,
                                         double_buffer=self._xla_dpu)
        self._xla_publish_all()

    # -- the compute copy ---------------------------------------------------
    def _row_is_host_order(self, i: int) -> bool:
        """Piece ``i``'s row is the rank's whole piece of the leaf in its
        own (layer-major) order: no dim moved, no padded chunk."""
        dd = self._flat_layout[i].data_dim
        return dd == 0 or (dd is None and self.dp_world_size == 1)

    def _xla_sink(self, i: int):
        """Streamed leaf ``i``'s pinned host compute copy, flat, when the
        update can write its row there directly; else None."""
        st = self._zero.streamer
        if st is None or i not in st.leaves or not self._row_is_host_order(i):
            return None
        return st.leaves[i].view(-1)

    def _xla_publish(self, i: int, row: Optional[torch.Tensor]) -> None:
        """Piece ``i``'s updated compute row as the forward's source: the
        rank's shard at stage 3, else all-gathered over ``data`` and
        unpacked; a streamed leaf's goes to its pinned host copy (None:
        the update wrote it there)."""
        if row is None:
            return
        rt = self._zero
        rec = self._flat_layout[i]
        if rt.stage >= 3 and rec.data_dim is not None:
            src = unpack_row(row, rec, self.dp_world_size).contiguous()
        else:
            full = col.all_gather(row[None], self.mesh, DATA_AXIS, 0)
            src = unpack_leaf(full, rec).contiguous()
        if rt.streamed(i):
            rt.streamer.leaves[i].copy_(src)
            return
        rt.sources[i] = src

    def _xla_publish_all(self) -> None:
        """Every source from the pinned master (init and load)."""
        xp = self._xla
        xp.sync()
        for i, m in enumerate(xp.master):
            sink = self._xla_sink(i)
            if sink is not None:
                sink.copy_(m[:sink.numel()])
                continue
            self._xla_publish(i, m.to(self.device, non_blocking=False)
                              .to(self.compute_dtype))
        if self._zero.streamer is not None:
            self._zero.streamer.invalidate()

    def _xla_state(self):
        """(master, ``FusedAdamState``) over the pinned rows, each a
        ``(1, w)`` view: the engine's ``state`` for this tier."""
        xp = self._xla

        def rows(ts):
            return tuple(t.view(1, -1) for t in ts)
        return rows(xp.master), FusedAdamState(count=xp.count,
                                               mu=rows(xp.mu),
                                               nu=rows(xp.nu))

    def _xla_set_state(self) -> None:
        from .engine import TrainState
        master, opt = self._xla_state()
        self.state = TrainState(master_params=master, opt_state=opt,
                                scaler=self.state.scaler,
                                skipped_steps=self.state.skipped_steps)

    # -- the step -------------------------------------------------------------
    def _xla_check_poison(self) -> None:
        if self._fatal_state_error is not None:
            raise RuntimeError(self._fatal_state_error)

    def _xla_grads(self, batch, step_rng):
        """Every group's gradients as compute-dtype rows (device rows, or
        pinned host rows when the grads are chunked; a streamed leaf's
        fp32 host stack with its unscale), the combined finite flag, the
        global norm and the first group's scaled losses."""
        rt = self._zero
        dp, rank = self.dp_world_size, rt.dp_rank
        n = len(self._flat_layout)
        cdt = self.compute_dtype
        rows: list = [None] * n
        sq = torch.zeros(n, dtype=torch.float32, device=self.device)
        bad = torch.zeros((), dtype=torch.float32, device=self.device)
        losses = None
        if rt.streamer is not None:
            rt.streamer.begin_step()
        host_rows = None
        if self._xla_chunked:
            if self._xla_grad_sets is None:
                sets = 2 if self._xla_dpu else 1
                self._xla_grad_sets = [
                    [_pinned((rec.w,), cdt, self.device)
                     for rec in self._flat_layout] for _ in range(sets)]
                self._xla_grad_cur = 0
            self._xla_grad_cur = ((self._xla_grad_cur + 1)
                                  % len(self._xla_grad_sets))
            host_rows = self._xla_grad_sets[self._xla_grad_cur]
            self._xla_grad_stream = getattr(
                self, "_xla_grad_stream", None) or _cuda_stream(self.device)
        for k, gidx in enumerate(self._xla_groups):
            keep = frozenset(gidx) if self._xla_chunked else None
            grads, scaled = self._scaled_grads(batch, self.state.scaler,
                                               step_rng, keep=keep)
            if k == 0:
                losses = scaled
            with torch.no_grad():
                for i in gidx:
                    g = grads[i]
                    grads[i] = None
                    rec = self._flat_layout[i]
                    if isinstance(g, HostGrad):
                        norm = torch.linalg.vector_norm(g.acc).to(
                            self.device) * g.inv
                        sq[i] = norm * norm
                        bad = torch.maximum(
                            bad, (~torch.isfinite(norm)).float())
                        acc = (g.acc.view(-1) if self._row_is_host_order(i)
                               else pack_row(g.acc, rec, dp,
                                             rank).contiguous())
                        rows[i] = (acc, g.inv)
                        continue
                    sq[i] = g.float().square().sum()
                    bad = torch.maximum(
                        bad, (~torch.isfinite(g).all()).float())
                    row = pack_row(g, rec, dp, rank).to(cdt)
                    del g
                    if host_rows is None:
                        rows[i] = (row, None)
                        continue
                    buf = host_rows[i]
                    gs = self._xla_grad_stream
                    if gs is None:
                        buf.copy_(row)
                    else:
                        gs.wait_stream(torch.cuda.current_stream(
                            self.device))
                        with torch.cuda.stream(gs):
                            buf.copy_(row, non_blocking=True)
                            row.record_stream(gs)
                    rows[i] = (buf, None)
            del grads
        ready = None
        if host_rows is not None and self._xla_grad_stream is not None:
            # the update's H2D stream reads these rows after this event
            ready = torch.cuda.Event()
            ready.record(self._xla_grad_stream)
        with torch.no_grad():
            finite = col.pmax(bad, self.mesh, "world") == 0
            norm = rt.leaf_sums(sq[:, None])[:, 0].sum().sqrt()
            mean_loss = col.pmean(
                torch.stack(losses).mean() / self.state.scaler.loss_scale,
                self.mesh, DATA_AXIS)
        return rows, finite, norm, mean_loss, ready

    def _xla_update(self, rows, finite, norm, mean_loss, ready=None,
                    timing: bool = False) -> torch.Tensor:
        """Step t's update from its gradient rows; returns the packed
        metrics.  The split arm poisons the engine on a failure."""
        from . import precision
        from .engine import TrainState
        st = self.state
        scaler = st.scaler
        xp = self._xla
        hp = self._xla_hyper
        with torch.no_grad():
            c1, c2, lr, cs = offload_update_scalars(
                xp.count, norm, b1=hp.b1, b2=hp.b2,
                bias_correction=self._xla_bias_correction,
                clip=float(self.gradient_clipping), lr_at=self._lr_at)
            sinks = [self._xla_sink(i) for i in range(len(rows))]
            split = self._xla_split
            done = [0]

            def on_piece(i, row):
                done[0] += 1
                if split:
                    self._xla_publish(i, row)

            try:
                outs = xp.update(rows, finite, c1, c2, lr, cs, hp,
                                 sinks=sinks, in_place=split,
                                 on_piece=on_piece, timing=timing,
                                 ready=ready)
            except BaseException as e:
                if not split:
                    raise
                self._fatal_state_error = (
                    f"offload_split_update failed after {done[0]}/"
                    f"{len(rows)} piece updates: the applied pieces' "
                    "previous state was overwritten in place, so this "
                    "engine's optimizer state is unusable. load_checkpoint "
                    "on this engine (or rebuild it) to recover. Original "
                    f"error: {e!r}")
                if not isinstance(e, Exception):
                    raise
                raise RuntimeError(self._fatal_state_error) from e
            if not split:
                for i, row in enumerate(outs):
                    self._xla_publish(i, row)
            if self._zero.streamer is not None:
                self._zero.streamer.invalidate(xp.d2h_event())
            xp.count = xp.count + finite.to(torch.int32)
            new_scaler = precision.update_scale(scaler, finite,
                                                self.loss_scale_config)
            new_skipped = st.skipped_steps + (~finite).to(torch.int32)
            packed = torch.stack([
                mean_loss.float(), norm.float(), scaler.loss_scale.float(),
                (~finite).float(), self._lr_at(xp.count).reshape(())])
        self.state = TrainState(master_params=st.master_params,
                                opt_state=st.opt_state, scaler=new_scaler,
                                skipped_steps=new_skipped)
        self._xla_set_state()
        return packed

    def _train_step_xla(self, batch) -> torch.Tensor:
        """One XLA-tier step on a placed batch; returns the packed
        metrics (no value read back, except the delayed update's
        previous overflow flag)."""
        self._xla_check_poison()
        timing = bool(getattr(self, "_xla_timing", False))
        if not self._xla_dpu:
            step_rng = fold_in(self._rng, self.global_steps)
            return self._xla_update(*self._xla_grads(batch, step_rng),
                                    timing=timing)
        prev = self._xla_dpu_pending
        if prev is not None and not bool(prev[1]):
            # an overflow at t-1: apply (skip) it before dispatching t, so
            # t's grads run at the reacted scale (one skip per overflow)
            self._xla_dpu_pending = None
            self._xla_update(*prev)
            prev = None
        seed = self._xla_dpu_dispatch
        self._xla_dpu_dispatch += 1
        pending = self._xla_grads(batch, fold_in(self._rng, seed))
        self._xla_dpu_pending = pending
        if prev is not None:
            packed = self._xla_update(*prev, timing=timing)
        else:
            zero = torch.zeros((), device=self.device)
            packed = torch.stack([
                zero, zero, self.state.scaler.loss_scale.float(), zero,
                self._lr_at(self._xla.count).reshape(())])
        # this step's loss (scaled at the scale its grads ran under) with
        # the applied update's norm, scale and lr
        return torch.cat([pending[3].float().reshape(1), packed[1:]])

    def _xla_dpu_flush(self) -> None:
        """Apply a pending delayed update (a save, an eval and a load see
        the fully-applied master)."""
        pending = getattr(self, "_xla_dpu_pending", None)
        if pending is not None:
            self._xla_dpu_pending = None
            self._xla_update(*pending)

    # -- checkpoints: the canonical tree --------------------------------------
    def _xla_gather_rows(self, rows: List[torch.Tensor], i: int):
        """Piece ``i``'s ``(dp, w)`` rows from every data rank (host)."""
        r = rows[i].to(self.device)
        return col.all_gather(r[None], self.mesh, DATA_AXIS, 0).cpu()

    def _xla_leaf(self, rows: List[torch.Tensor], i: int) -> torch.Tensor:
        """Leaf ``i`` of one plane in the master's placement (the rank's
        shard, or the whole piece for a padded leaf), on the host."""
        rec = self._flat_layout[i]
        if rec.data_dim is not None:
            return unpack_row(rows[i], rec, self.dp_world_size).contiguous()
        return unpack_leaf(self._xla_gather_rows(rows, i), rec).contiguous()

    def _xla_canonical(self):
        """(master leaves, mu leaves, nu leaves, count) in the master's
        placement, from the pinned pieces."""
        xp = self._xla
        xp.sync()
        n = len(self._flat_layout)
        return ([self._xla_leaf(xp.master, i) for i in range(n)],
                [self._xla_leaf(xp.mu, i) for i in range(n)],
                [self._xla_leaf(xp.nu, i) for i in range(n)], xp.count)

    def _xla_adopt(self, master, mu, nu, count: int) -> None:
        """Loaded leaves (the master's placement) packed into the pinned
        rows; every source republished; the poison and any pending delayed
        update cleared; the dispatch counter restored from
        ``global_steps`` by the loader."""
        dp, rank = self.dp_world_size, self._zero.dp_rank

        def rows(leaves):
            if leaves is None:
                return [None] * len(self._flat_layout)
            return [pack_row(torch.as_tensor(x).float().cpu(), rec, dp,
                             rank)
                    for x, rec in zip(leaves, self._flat_layout)]
        self._xla_dpu_pending = None
        self._fatal_state_error = None
        self._xla.load(rows(master), rows(mu), rows(nu), count)
        self._xla_publish_all()
        self._xla_set_state()

    def _unflatten_numpy(self, pieces):
        """``(dp, w)`` pieces -> the parameter tree (numpy; the checkpoint
        pair of the layout)."""
        from .engine import _unflatten_like
        leaves = [unpack_leaf(np.asarray(p), rec)
                  for p, rec in zip(pieces, self._flat_layout)]
        return _unflatten_like(self._zero.template, leaves)

    def _flatten_numpy(self, tree):
        dp = self.dp_world_size
        return tuple(pack_leaf(np.asarray(x, np.float32), rec, dp)
                     for x, rec in zip(tree_leaves(tree), self._flat_layout))
