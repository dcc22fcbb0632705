"""Static-shape continuous batching: the host-side slot scheduler,
page allocator, and prefix cache.

Orca-style iteration-level scheduling (PAPERS.md) re-expressed in the
repo's static-shape idiom: the device never sees a batch-size change.
A fixed pool of ``slots`` decodes every tick; requests are ADMITTED
into free slots (a prefill writes their K/V rows in place) and EVICTED
the moment they finish (EOS / max_new_tokens / KV capacity), so a new
request starts decoding on the very next tick — no waiting for the
batch to drain, which is the whole continuous-batching win
(bench_serve.py measures it).

Eviction is pure host bookkeeping: the slot's ``lengths`` entry is
overwritten by the next admission and the decode program masks the
stale rows meanwhile.  The device-side mirror of this file is the
``active`` mask the engine passes into the one compiled decode program.

Paged mode (``serving.page_len > 0``, docs/serving.md) adds two more
host-only structures mirroring vLLM's block manager and SGLang's radix
cache (PAPERS.md):

  :class:`PagePool`     refcounted free-list allocator over the flat
                        device page pool (page 0 reserved as scratch).
                        Deque-backed — O(1) alloc/free at any pool size.
  :class:`PrefixCache`  chain-hashed shared prompt prefixes: full pages
                        key by a running digest, the last partial page
                        by its literal tokens under its parent digest.
                        Entries hold a pool ref; leaf-LRU eviction under
                        pool pressure, copy-on-write when a hitter must
                        append into a shared partial page.

Everything here is engine-thread-confined; the request queue in front
(a stages Channel) is the concurrent boundary.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class Request:
    """One generation request and its lifecycle record."""
    rid: int
    prompt: List[int]
    max_new_tokens: int
    eos_id: Optional[int] = None
    submit_t: float = 0.0
    #: generated token ids (the first comes from the prefill logits)
    tokens: List[int] = dataclasses.field(default_factory=list)
    #: wall seconds per generated token (first = time-to-first-token)
    token_times: List[float] = dataclasses.field(default_factory=list)
    finish_reason: Optional[str] = None
    error: Optional[BaseException] = None
    slot: Optional[int] = None
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    #: host-side decode bookkeeping (engine-internal)
    last_token: int = 0
    last_t: float = 0.0
    kv_len: int = 0
    #: causal trace (docs/observability.md, engine-internal): the
    #: request's TraceContext plus its open root/queue-wait span handles
    ctx: Optional[object] = None
    span: Optional[object] = None
    queue_span: Optional[object] = None
    #: latency attribution stamps: admission time (queue_wait ends) and
    #: the prefill's wall time — queue/prefill/decode components of the
    #: per-request completion record
    admit_t: float = 0.0
    prefill_s: float = 0.0
    #: paged mode (engine-internal): the slot's live page ids in table
    #: order, the prompt prefix length served from shared pages, and
    #: how many prompt tokens the prefill actually computed (the delta)
    pages: Optional[List[int]] = None
    shared_len: int = 0
    computed_len: int = 0
    #: speculative decoding (engine-internal, serving.speculate_k > 0):
    #: accepted draft tokens per verify pass — the per-request record
    #: of the uneven per-slot progress the masked slot machinery
    #: absorbs (docs/serving.md "speculative decoding")
    spec_accepted: List[int] = dataclasses.field(default_factory=list)
    #: chunked prefill (serving.prefill_chunk_len > 0): while True the
    #: slot is mid-prefill — decode ticks mask it out and step() feeds
    #: it one chunk at a time; chunk_pos = prompt tokens prefilled so
    #: far past shared_len
    prefilling: bool = False
    chunk_pos: int = 0
    #: KV-migration handoff (disaggregated fleet): finish without
    #: releasing the slot's pages — the replica loop exports them over
    #: the wire, then drops them explicitly
    detach_kv: bool = False
    #: tenant adapter id (0 = base model, no LoRA delta).  The engine
    #: resolves this to an HBM pool slot at admission and parks on
    #: pool-dry exactly like a pages-dry admission
    adapter_id: int = 0
    #: resolved HBM adapter-pool slot (0 = the reserved zero adapter);
    #: engine-owned, valid only while the request holds a batch slot
    adapter_slot: int = 0

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until the request finishes; raises its error if it
        failed (typed propagation — the original exception)."""
        if not self.done.wait(timeout=timeout):
            raise TimeoutError(
                f"request {self.rid} not finished after {timeout}s")
        if self.error is not None:
            raise self.error
        return list(self.tokens)


class SlotScheduler:
    """Free-list + active map over the fixed slot pool.  Host-only and
    engine-thread-confined; the request queue in front of it (a stages
    Channel) is the concurrent boundary."""

    def __init__(self, slots: int):
        self.slots = int(slots)
        # deque, not list: pop(0) on a list shifts the whole free list —
        # O(n) per admission, real money at fleet-scale pools
        self.free: deque = deque(range(self.slots))
        self.active: Dict[int, Request] = {}

    def has_free(self) -> bool:
        return bool(self.free)

    def admit(self, req: Request, now: Optional[float] = None) -> int:
        slot = self.free.popleft()
        req.slot = slot
        req.last_t = now if now is not None else time.perf_counter()
        self.active[slot] = req
        return slot

    def release(self, slot: int, reason: str) -> Request:
        req = self.active.pop(slot)
        self.free.append(slot)
        req.finish_reason = reason
        req.slot = None
        return req

    def finish_reason(self, req: Request, token: int,
                      max_len: int) -> Optional[str]:
        """Why this just-emitted token ends the request (None = keep
        decoding): EOS, the per-request generation budget, or the
        slot's KV capacity (the static-shape hard stop)."""
        if req.eos_id is not None and token == req.eos_id:
            return "eos"
        if len(req.tokens) >= req.max_new_tokens:
            return "length"
        if req.kv_len >= max_len:
            return "kv_capacity"
        return None


# ---------------------------------------------------------------------------
# paged mode: the refcounted page allocator
# ---------------------------------------------------------------------------


#: the reserved scratch page — masked (inactive-slot) writes of the
#: decode/prefill programs land here, so write conflicts can only be
#: no-op-vs-no-op.  Never allocated, never freed, always a valid index.
SCRATCH_PAGE = 0


class PagePool:
    """Host-side free-list allocator over the flat device page pool.

    Pages are plain int ids into the ``[L, P, H, page_len, Dh]`` pool
    arrays; a page is storage for ``page_len`` KV rows of every layer.
    Refcounts make sharing safe: a page is held by the slot(s) whose
    page tables reference it plus (optionally) a :class:`PrefixCache`
    entry, and returns to the free deque only when the last holder
    derefs.  O(1) alloc/free — the free list is a deque, the same
    satellite as the slot scheduler's."""

    def __init__(self, pages: int):
        if pages < 2:
            raise ValueError(
                f"PagePool needs >= 2 pages (page {SCRATCH_PAGE} is the "
                f"reserved scratch page), got {pages}")
        self.pages = int(pages)
        self.free: deque = deque(range(1, self.pages))
        self.refs: Dict[int, int] = {}

    @property
    def free_count(self) -> int:
        return len(self.free)

    @property
    def used_count(self) -> int:
        """Allocated pages (excludes the scratch page)."""
        return self.pages - 1 - len(self.free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` fresh pages with refcount 1 each, or None (and no
        side effects) when the pool can't satisfy the request — the
        caller's backpressure/eviction point."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self.free):
            return None
        out = [self.free.popleft() for _ in range(n)]
        for p in out:
            self.refs[p] = 1
        return out

    def ref(self, page: int) -> None:
        if page == SCRATCH_PAGE:
            raise ValueError("the scratch page is never refcounted")
        self.refs[page] += 1

    def deref(self, page: int) -> None:
        """Drop one hold; the last hold frees the page back to the
        deque.  Over-deref is a bookkeeping bug and raises."""
        if page not in self.refs:
            raise AssertionError(
                f"page {page} deref'd below zero (double free)")
        n = self.refs[page] - 1
        if n == 0:
            del self.refs[page]
            self.free.append(page)
        else:
            self.refs[page] = n


# ---------------------------------------------------------------------------
# prefix reuse: chain-hashed shared pages (RadixAttention, PAPERS.md)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _FullEntry:
    """A full shared page: ``page_len`` prompt tokens, keyed by the
    running chain digest (parent digest + this page's tokens), so a
    match at depth i implies every shallower page matched too."""
    page: int
    parent: str
    children: int = 0
    last_hit: int = 0


@dataclasses.dataclass
class _PartialEntry:
    """The last PARTIAL page of a cached prompt: ``tokens`` literal
    rows [0, m) of ``page``, keyed under the parent full-page digest.
    Always a leaf — a hitter that extends it copy-on-writes first.
    Rows >= m of the page belong to the registering request's later
    tokens/appends and are never read through this entry."""
    tokens: Tuple[int, ...]
    page: int
    parent: str
    last_hit: int = 0


class PrefixCache:
    """Shared prompt prefixes over pool pages.

    Only ``prompt[:-1]`` is cacheable — the last prompt token must
    always be computed so prefill has logits to emit the first
    generated token from (the vLLM rule).  Full pages chain-hash; the
    partial tail keys by its literal tokens under the parent digest.
    Every entry holds one pool ref on its page; ``evict()`` walks
    leaf-first LRU (an inner full page never outlives a cached child
    that chains through it) and is the allocator's pressure valve.
    """

    def __init__(self, page_len: int, pool: PagePool):
        self.page_len = int(page_len)
        self.pool = pool
        self.full: Dict[str, _FullEntry] = {}
        self.partials: Dict[str, Dict[Tuple[int, ...], _PartialEntry]] = {}
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.cow = 0
        self._clock = 0

    # -- internals -------------------------------------------------------
    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    @staticmethod
    def _digest(parent: str, tokens: Sequence[int]) -> str:
        h = hashlib.sha1(parent.encode("ascii"))
        h.update(b"|")
        h.update(",".join(str(int(t)) for t in tokens).encode("ascii"))
        return h.hexdigest()

    @property
    def entries(self) -> int:
        return len(self.full) + sum(len(d) for d in self.partials.values())

    # -- lookup ----------------------------------------------------------
    def match(self, prompt: Sequence[int],
              namespace: str = "") -> Tuple[int, List[int], bool]:
        """Longest cached prefix of ``prompt`` (never the whole prompt:
        at least one token is left for the delta prefill).

        ``namespace`` partitions the cache: digests chain from it as the
        root parent, so two tenants with identical prompts but different
        adapters can never share KV pages (the LoRA delta makes their
        caches semantically different).  ``""`` keeps digests bitwise
        identical to the un-namespaced cache.

        Returns ``(shared_len, pages, cow)`` with one pool ref taken on
        every returned page (the caller owns them now — roll back with
        ``release`` if admission fails).  ``pages[i]`` covers positions
        ``[i*page_len, (i+1)*page_len)``; when ``cow`` is True the last
        entry is a shared PARTIAL page the caller must copy-on-write
        before its first append (``shared_len`` ends inside it)."""
        limit = len(prompt) - 1
        parent = namespace
        pages: List[int] = []
        pos = 0
        while pos + self.page_len <= limit:
            d = self._digest(parent, prompt[pos:pos + self.page_len])
            e = self.full.get(d)
            if e is None:
                break
            e.last_hit = self._tick()
            self.pool.ref(e.page)
            pages.append(e.page)
            parent = d
            pos += self.page_len
        cow = False
        best: Optional[_PartialEntry] = None
        remaining = prompt[pos:]
        for toks, pe in (self.partials.get(parent) or {}).items():
            m = len(toks)
            # m <= limit - pos keeps shared_len <= len(prompt)-1
            if m <= limit - pos and tuple(remaining[:m]) == toks \
                    and (best is None or m > len(best.tokens)):
                best = pe
        if best is not None:
            best.last_hit = self._tick()
            self.pool.ref(best.page)
            pages.append(best.page)
            pos += len(best.tokens)
            cow = True
        # stats are counted per ADMISSION (note_admission), not per
        # match call: a backpressure-parked request re-matches every
        # tick and must not inflate the hit ratio/token scalars
        return pos, pages, cow

    def note_admission(self, shared_len: int) -> None:
        """Count one successful admission's prefix outcome — the
        source of the ``serve_prefix_*`` flush scalars."""
        if shared_len > 0:
            self.hits += 1
            self.hit_tokens += shared_len
        else:
            self.misses += 1

    def release(self, pages: Sequence[int]) -> None:
        """Roll back the refs a failed admission took via ``match``."""
        for p in pages:
            self.pool.deref(p)

    # -- registration ----------------------------------------------------
    def insert(self, prompt: Sequence[int],
               pages: Sequence[int], namespace: str = "") -> int:
        """Register a just-prefilled prompt's pages: full pages of
        ``prompt[:-1]`` chain in as :class:`_FullEntry`, a nonempty
        partial tail as :class:`_PartialEntry`.  Pages already cached
        (the request's own prefix hit) are skipped; each NEW entry
        takes one pool ref on its page.  ``namespace`` must match the
        one used at :meth:`match` time.  Returns entries added."""
        limit = len(prompt) - 1
        parent = namespace
        added = 0
        pos = 0
        i = 0
        while pos + self.page_len <= limit:
            d = self._digest(parent, prompt[pos:pos + self.page_len])
            e = self.full.get(d)
            if e is None:
                self.pool.ref(pages[i])
                self.full[d] = _FullEntry(page=pages[i], parent=parent,
                                          last_hit=self._tick())
                if parent in self.full:
                    self.full[parent].children += 1
                added += 1
            parent = d
            pos += self.page_len
            i += 1
        tail = tuple(int(t) for t in prompt[pos:limit])
        if tail:
            bucket = self.partials.setdefault(parent, {})
            if tail not in bucket:
                self.pool.ref(pages[i])
                bucket[tail] = _PartialEntry(tokens=tail, page=pages[i],
                                             parent=parent,
                                             last_hit=self._tick())
                if parent in self.full:
                    self.full[parent].children += 1
                added += 1
        return added

    # -- eviction (the allocator's pressure valve) -----------------------
    def _evictable(self):
        for parent, bucket in self.partials.items():
            for toks, pe in bucket.items():
                yield pe.last_hit, ("partial", parent, toks)
        for d, fe in self.full.items():
            if fe.children == 0 and d not in self.partials:
                yield fe.last_hit, ("full", d, None)

    def drop_leaf(self, kind: str, key: str,
                  sub: Optional[Tuple[int, ...]]) -> int:
        """Remove one LEAF entry (a ``_evictable`` candidate) and deref
        its page; returns the page id.  The one dict-surgery path both
        eviction and the KV tier's park (inference/kv_tier.py) go
        through — the tier exports + CRC-stamps the page's bytes BEFORE
        calling this, so the pool ref is only released once the host
        copy is durable."""
        if kind == "partial":
            pe = self.partials[key].pop(sub)
            if not self.partials[key]:
                del self.partials[key]
            if pe.parent in self.full:
                self.full[pe.parent].children -= 1
            self.pool.deref(pe.page)
            return pe.page
        fe = self.full.pop(key)
        if fe.parent in self.full:
            self.full[fe.parent].children -= 1
        self.pool.deref(fe.page)
        return fe.page

    def evict(self, need_free: int) -> int:
        """Drop least-recently-hit LEAF entries until the pool's free
        count reaches ``need_free`` (or nothing evictable remains).
        Dropping an entry derefs its page — the page is actually freed
        only if no live slot still reads it.  Returns entries evicted.
        Leaf-first keeps every cached chain reachable: an inner page is
        only evictable once nothing chains through it."""
        evicted = 0
        while self.pool.free_count < need_free:
            # min(), not sorted(): this runs on the admission/append
            # hot path — O(E) per freed page, never a full resort
            cand = min(self._evictable(), default=None)
            if cand is None:
                break
            _, (kind, key, sub) = cand
            self.drop_leaf(kind, key, sub)
            evicted += 1
        return evicted

    def clear(self) -> int:
        """Drop every entry (engine shutdown): deref all cached pages."""
        n = 0
        for fe in self.full.values():
            self.pool.deref(fe.page)
            n += 1
        for bucket in self.partials.values():
            for pe in bucket.values():
                self.pool.deref(pe.page)
                n += 1
        self.full.clear()
        self.partials.clear()
        return n
