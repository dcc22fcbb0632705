"""KV tiering: park idle sessions' KV pages on host RAM and disk — a
copy of ``deepspeed_tpu/inference/kv_tier.py`` (it imports no JAX), with
the one function it needs from the JAX package's ``runtime/
disk_offload.py`` (``disk_fsync_enabled``) kept here.  A page file is the
JAX package's ``DSDISK1`` format byte for byte, so either package reads
the other's parked pages.

Conversational users who go idle for minutes dominate serving traffic,
yet their prefix-cache KV pages pin HBM forever.  This module is the
serving-side mirror of the ZeRO-Infinity offload discipline of the JAX
package's training engine (``runtime/disk_offload.py``): cold pages
spill HBM -> host RAM -> disk and stream back on session resume, at the
page granularity vLLM's swap plane and SGLang's radix cache establish.

The tier owns no device state.  It watches the :class:`PrefixCache`
for leaves that have sat idle for ``idle_park_ticks`` engine ticks,
exports each one's pool page to host bytes, CRC-stamps the copy, and
only THEN releases the pool ref (``PrefixCache.drop_leaf``) — a parked
page's bytes are durable before the pool can hand the page to anyone
else.  Over ``host_budget_pages`` the oldest host copies write back to
``disk_dir`` in the disk offload tier's leaf-state file format verbatim
(magic, JSON section header, per-section CRC, tmp+rename under
``io_retry``); with
no disk tier they are dropped and the session recomputes on resume.

Resume continues the prefix-cache digest chain from where ``match``
stopped: each parked record whose digest matches the next page of the
prompt is fetched (disk read CRC-verifies before any byte re-enters
the pool; the host copy re-verifies at page-in), imported into a fresh
pool page, and handed to admission, which registers the pages back
into the :class:`PrefixCache` — resume IS a prefix-cache hit, and the
delta-aware prefill computes only the unfetched tail.

Robustness is the headline, and all of it rides the two Stages:

* ``kv_spill`` (points ``pageout``, ``write``) — transient failures
  retry up to the budget, then the stage DEGRADES with ONE loud
  warning and sessions simply stay HBM-resident (parking disabled).
* ``kv_fetch`` (points ``read``, ``pagein``) — any fetch failure drops
  the bad record and stops extending the match; the already-verified
  prefix is kept and the remaining tokens recompute from the prompt
  via the existing delta prefill.  A CRC flip raises the typed
  :class:`KVTierCorruptError` BEFORE the page re-enters the pool —
  never a poisoned stream, never a lost request.

``DS_STAGE_FAULT`` / ``DS_STAGE_DELAY_S`` chaos specs target all four
points (docs/stages.md contract table).
"""
from __future__ import annotations

import dataclasses
import json
import os
import struct
import time
import zlib
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..runtime.resilience import (CheckpointCorruptError, DEFAULT_RETRY,
                                  RetryPolicy, io_retry)
from ..runtime.stages import Stage
from ..utils.logging import logger
from .scheduler import PrefixCache

__all__ = ["KVTier", "KVTierCorruptError", "KVTierDiskStore",
           "disk_fsync_enabled"]

# The disk offload tier's magic, verbatim: a parked-page file and a leaf-state
# file are the same on-disk dialect (magic + little-endian u64 header
# length + JSON section header + CRC'd raw payload).
_MAGIC = b"DSDISK1\n"


def disk_fsync_enabled(config_default: bool = True) -> bool:
    """Per-file fsync before each page file's rename: ON unless the
    ``serving.kv_tier.fsync`` knob or the ``DS_DISK_FSYNC=0`` env var
    turns it off (tests simulate process death, which the page cache
    survives).  A torn write is still caught by the CRC plane."""
    return bool(config_default) and os.environ.get(
        "DS_DISK_FSYNC", "1") != "0"


class KVTierCorruptError(CheckpointCorruptError):
    """A parked KV page failed verification (bad magic/header, short
    read, CRC flip, size mismatch) — raised BEFORE any byte re-enters
    the pool.  Not an ``OSError``: ``Stage.call`` propagates it on the
    first hit instead of retrying, and the resume path catches it,
    drops the record, and falls back to recompute-from-prompt."""


class KVTierDiskStore:
    """Parked-page files in the disk tier.

    One file per parked page, in the disk offload tier's leaf-state
    format: ``_MAGIC``, ``<Q`` header length, JSON header whose ``sections`` entry carries
    the payload's dtype/shape/CRC/offset, then the raw payload.  Writes
    go to ``<path>.tmp`` and rename into place (a crash mid-write can
    never leave a half-written file under the real name), optionally
    fsynced, all inside ``io_retry``.  Reads verify magic, header, and
    CRC and raise :class:`KVTierCorruptError` before returning bytes —
    a missing file is the same verdict (the record is unservable)."""

    def __init__(self, directory: str, fsync: bool = True,
                 retry: RetryPolicy = DEFAULT_RETRY):
        self.directory = str(directory)
        self.fsync = bool(fsync)
        self.retry = retry
        os.makedirs(self.directory, exist_ok=True)

    def path(self, name: str) -> str:
        return os.path.join(self.directory, f"kv_{name}.page")

    def write(self, name: str, payload: bytes) -> int:
        header = {
            "record": name,
            "sections": {
                "page": {"dtype": "uint8", "store_dtype": "uint8",
                         "shape": [len(payload)],
                         "crc32": zlib.crc32(payload) & 0xFFFFFFFF,
                         "offset": 0, "nbytes": len(payload)},
            },
        }
        blob = json.dumps(header).encode("utf-8")
        path = self.path(name)
        tmp = path + ".tmp"

        def do_write():
            with open(tmp, "wb") as f:
                f.write(_MAGIC)
                f.write(struct.pack("<Q", len(blob)))
                f.write(blob)
                f.write(payload)
                f.flush()
                if self.fsync:
                    os.fsync(f.fileno())
            os.rename(tmp, path)

        io_retry(do_write, f"kv-tier write {path}", self.retry)
        return len(payload)

    def read(self, name: str) -> bytes:
        path = self.path(name)

        def do_read():
            with open(path, "rb") as f:
                magic = f.read(len(_MAGIC))
                if magic != _MAGIC:
                    raise KVTierCorruptError(
                        f"kv-tier page {path} has bad magic "
                        f"{magic!r} (expected {_MAGIC!r})")
                raw_len = f.read(8)
                if len(raw_len) != 8:
                    raise KVTierCorruptError(
                        f"kv-tier page {path} is truncated in its "
                        "header length")
                (hlen,) = struct.unpack("<Q", raw_len)
                try:
                    header = json.loads(f.read(hlen).decode("utf-8"))
                except (ValueError, UnicodeDecodeError) as e:
                    raise KVTierCorruptError(
                        f"kv-tier page {path} has an unparseable "
                        f"header: {e}") from e
                ent = (header.get("sections") or {}).get("page")
                if ent is None:
                    raise KVTierCorruptError(
                        f"kv-tier page {path} header has no 'page' "
                        "section")
                base = len(_MAGIC) + 8 + hlen
                f.seek(base + int(ent["offset"]))
                raw = f.read(int(ent["nbytes"]))
                if len(raw) != int(ent["nbytes"]):
                    raise KVTierCorruptError(
                        f"kv-tier page {path} is truncated: section "
                        f"'page' wanted {int(ent['nbytes'])} bytes, "
                        f"got {len(raw)}")
                got = zlib.crc32(raw) & 0xFFFFFFFF
                if got != int(ent["crc32"]):
                    raise KVTierCorruptError(
                        f"kv-tier page {path} failed its CRC check: "
                        f"stored {int(ent['crc32'])}, computed {got}")
                return raw

        try:
            return io_retry(do_read, f"kv-tier read {path}", self.retry)
        except FileNotFoundError as e:
            raise KVTierCorruptError(
                f"kv-tier parked page {path} is missing") from e

    def remove(self, name: str) -> None:
        """Best-effort unlink of a consumed record's file."""
        try:
            os.unlink(self.path(name))
        except OSError:
            pass


@dataclasses.dataclass
class _Parked:
    """One parked page.  ``payload`` is the host copy (``None`` once
    written back to disk or consumed); ``crc``/``nbytes`` stamp it the
    moment it leaves the pool and gate every re-entry."""
    kind: str                          # "full" | "partial"
    key: str                           # chain digest / parent digest
    tokens: Optional[Tuple[int, ...]]  # partial's literal tokens
    parent: str                        # parent digest (session chain)
    crc: int
    nbytes: int
    payload: Optional[bytes]
    stamp: int                         # park order, oldest spills first
    on_disk: bool = False
    dead: bool = False                 # consumed/dropped (lazy dequeue)

    def record_name(self) -> str:
        if self.kind == "partial":
            return PrefixCache._digest(self.key + "#p",
                                       self.tokens or ())
        return self.key


class KVTier:
    """Host/disk tier for cold prefix-cache KV pages.

    The engine calls :meth:`park_tick` once per tick (before
    admission, so freed pages are immediately allocatable) and
    :meth:`resume` from paged admission to extend a prefix-cache match
    with parked pages.  Everything else — budgets, write-back, CRC
    discipline, degradation — is internal.

    ``exporter(page) -> bytes`` and ``importer(page, payload)`` are the
    engine's device<->host seams (``_export_page_bytes`` /
    ``_import_page_bytes``); the tier never touches device arrays."""

    def __init__(self, *, page_len: int, pool, prefix: PrefixCache,
                 exporter: Callable[[int], bytes],
                 importer: Callable[[int, bytes], None],
                 idle_park_ticks: int, host_budget_pages: int = 256,
                 disk_dir: Optional[str] = None, fsync: bool = True,
                 max_failures: Optional[int] = None,
                 retry: RetryPolicy = DEFAULT_RETRY):
        self.page_len = int(page_len)
        self.pool = pool
        self.prefix = prefix
        self.exporter = exporter
        self.importer = importer
        self.idle_park_ticks = int(idle_park_ticks)
        self.host_budget_pages = int(host_budget_pages)
        self.disk = (KVTierDiskStore(disk_dir, fsync=fsync, retry=retry)
                     if disk_dir else None)
        self.spill_stage = Stage(
            "kv_spill", max_failures=max_failures,
            fallback="HBM-resident sessions (parking disabled)")
        self.fetch_stage = Stage(
            "kv_fetch", max_failures=max_failures,
            fallback="recompute-from-prompt resume")
        # parked-record index, keyed the same way the prefix cache is
        self._full: Dict[str, _Parked] = {}
        self._partials: Dict[str, Dict[Tuple[int, ...], _Parked]] = {}
        # host-residency accounting: deque in park order (lazy-skip of
        # dead/diskized records) + an exact resident-page count
        self._host: deque = deque()
        self._host_pages = 0
        # idleness tracking: (last_hit snapshot, tick it was taken)
        self._seen: Dict[Tuple[str, str, Optional[Tuple[int, ...]]],
                         Tuple[int, int]] = {}
        self._stamp = 0
        self._closed = False
        # counters (the engine's flush mirrors these into telemetry)
        self.spill_bytes = 0
        self.fetch_bytes = 0
        self.parked_pages_total = 0
        self.resumed_pages_total = 0
        self.resumed_sessions_total = 0
        self.corrupt_total = 0
        self.dropped_total = 0
        self.resume_s: deque = deque(maxlen=2048)

    # -- inventory -------------------------------------------------------
    @property
    def parked_pages(self) -> int:
        return len(self._full) + sum(len(b)
                                     for b in self._partials.values())

    @property
    def parked_sessions(self) -> int:
        """Parked chain TAILS — the sessions this tier is holding off
        HBM (a mid-chain full page whose child is also parked is one
        session, not two)."""
        parents = {r.parent for r in self._full.values()}
        n = sum(len(b) for b in self._partials.values())
        n += sum(1 for d in self._full
                 if d not in parents and d not in self._partials)
        return n

    def resume_p99_s(self) -> Optional[float]:
        if not self.resume_s:
            return None
        xs = sorted(self.resume_s)
        return xs[min(len(xs) - 1, int(0.99 * len(xs)))]

    # -- park plane (kv_spill) -------------------------------------------
    def park_tick(self, tick: int) -> int:
        """Scan the prefix cache for leaves idle >= ``idle_park_ticks``
        engine ticks and park them.  Never raises: a failing record
        stays HBM-resident and the scan stops; persistent failures
        degrade ``kv_spill`` (ONE warning) and the tier goes dormant."""
        if self._closed or self.idle_park_ticks <= 0 \
                or self.spill_stage.degraded:
            return 0
        live = set()
        cands = []
        for last_hit, (kind, key, sub) in self.prefix._evictable():
            k = (kind, key, sub)
            live.add(k)
            prev = self._seen.get(k)
            if prev is None or prev[0] != last_hit:
                self._seen[k] = (last_hit, tick)
            elif tick - prev[1] >= self.idle_park_ticks:
                cands.append((kind, key, sub))
        for k in [k for k in self._seen if k not in live]:
            del self._seen[k]
        parked = 0
        for kind, key, sub in cands:
            if self._closed or self.spill_stage.degraded:
                break
            try:
                self._park_one(kind, key, sub)
            except Exception as e:
                # the entry is still fully HBM-resident (the pool ref
                # is only dropped after the host copy is stamped) —
                # log, leave it, stop this tick's scan
                logger.error(
                    "kv tier: parking a %s entry failed; the session "
                    "stays HBM-resident: %r", kind, e)
                break
            parked += 1
            self._seen.pop((kind, key, sub), None)
        return parked

    def _park_one(self, kind: str, key: str,
                  sub: Optional[Tuple[int, ...]]) -> None:
        if kind == "partial":
            entry = self.prefix.partials[key][sub]
            parent = key
        else:
            entry = self.prefix.full[key]
            parent = entry.parent
        page = int(entry.page)
        payload = self.spill_stage.call(
            "pageout", lambda: self.exporter(page), path=f"page={page}")
        rec = _Parked(kind=kind, key=key, tokens=sub, parent=parent,
                      crc=zlib.crc32(payload) & 0xFFFFFFFF,
                      nbytes=len(payload), payload=payload,
                      stamp=self._stamp)
        self._stamp += 1
        if kind == "partial":
            self._partials.setdefault(key, {})[sub] = rec
        else:
            self._full[key] = rec
        # the host copy is CRC-stamped — only NOW may the pool ref go
        self.prefix.drop_leaf(kind, key, sub)
        self._host.append(rec)
        self._host_pages += 1
        self.parked_pages_total += 1
        self.spill_bytes += len(payload)
        self._shed_host()

    def _shed_host(self) -> None:
        """Write the oldest host copies back to disk (or drop them,
        with no disk tier) until the host budget holds."""
        while self._host_pages > self.host_budget_pages:
            rec = self._host.popleft()
            if rec.dead or rec.payload is None:
                continue
            if self.disk is None:
                self._remove(rec)
                self.dropped_total += 1
                continue
            payload = rec.payload
            name = rec.record_name()
            try:
                self.spill_stage.call(
                    "write",
                    lambda: self.disk.write(name, payload),
                    path=self.disk.path(name))
            except Exception as e:
                # keep the host copy; a later tick (or drain) retries
                self._host.appendleft(rec)
                logger.error(
                    "kv tier: host->disk write-back failed; keeping "
                    "the host copy: %r", e)
                break
            rec.payload = None
            rec.on_disk = True
            self._host_pages -= 1

    def drain(self) -> int:
        """Write EVERY host-resident parked page to the disk tier —
        the close-time drain barrier.  No-op without a disk tier."""
        if self.disk is None:
            return 0
        n = 0
        for rec in list(self._host):
            if rec.dead or rec.payload is None:
                continue
            payload = rec.payload
            name = rec.record_name()
            try:
                self.spill_stage.call(
                    "write",
                    lambda: self.disk.write(name, payload),
                    path=self.disk.path(name))
            except Exception as e:
                logger.error(
                    "kv tier: drain write-back failed: %r", e)
                break
            rec.payload = None
            rec.on_disk = True
            self._host_pages -= 1
            n += 1
        return n

    # -- resume plane (kv_fetch) -----------------------------------------
    def resume(self, prompt: Sequence[int], namespace: str, pos: int,
               alloc: Callable[[int], Optional[List[int]]],
               ) -> Tuple[int, List[int]]:
        """Extend a prefix-cache match with parked pages.

        ``pos`` is where ``PrefixCache.match`` stopped (page-aligned,
        no COW tail).  Walks the digest chain forward: every parked
        full record matching the next page of ``prompt`` is fetched,
        verified, and imported into a fresh pool page; a parked partial
        tail extends the match mid-page (the page is private, so no COW
        is needed).  Consumed records leave the tier — admission's
        ``PrefixCache.insert`` re-registers the pages.

        Returns ``(new_pos, pages)``; the pages carry one pool ref each
        and belong to the caller.  Any tier failure (corrupt record,
        I/O error, pool dry) stops the extension with the verified
        prefix intact — the remaining tokens recompute via the delta
        prefill.  Never raises for tier-internal failures."""
        limit = len(prompt) - 1
        pages: List[int] = []
        if self._closed or not self.parked_pages:
            return pos, pages
        t0 = time.perf_counter()
        parent = namespace
        q = 0
        while q + self.page_len <= pos:
            parent = PrefixCache._digest(
                parent, prompt[q:q + self.page_len])
            q += self.page_len
        try:
            while pos + self.page_len <= limit:
                d = PrefixCache._digest(
                    parent, prompt[pos:pos + self.page_len])
                rec = self._full.get(d)
                if rec is None or rec.dead:
                    break
                if not self._fetch_into(rec, alloc, pages):
                    break
                parent = d
                pos += self.page_len
            bucket = self._partials.get(parent)
            if bucket:
                best: Optional[Tuple[Tuple[int, ...], _Parked]] = None
                remaining = prompt[pos:]
                for toks, rec in bucket.items():
                    m = len(toks)
                    if not rec.dead and m <= limit - pos \
                            and tuple(remaining[:m]) == toks \
                            and (best is None or m > len(best[0])):
                        best = (toks, rec)
                if best is not None \
                        and self._fetch_into(best[1], alloc, pages):
                    pos += len(best[0])
        except BaseException:
            # only a non-tier failure (device import crash, interrupt)
            # lands here; the fetched pages never reached the caller —
            # return their refs before re-raising
            for p in pages:
                self.pool.deref(p)
            raise
        if pages:
            self.resumed_pages_total += len(pages)
            self.resumed_sessions_total += 1
            self.resume_s.append(time.perf_counter() - t0)
        return pos, pages

    def _fetch_into(self, rec: _Parked,
                    alloc: Callable[[int], Optional[List[int]]],
                    pages: List[int]) -> bool:
        """Fetch ONE parked record into a fresh pool page; append the
        page to ``pages`` and consume the record on success.  Tier
        failures drop the record and return False (recompute covers
        it); non-tier failures propagate with the page ref returned."""
        got = alloc(1)
        if got is None:
            return False
        page = got[0]
        try:
            payload = rec.payload
            if payload is None:
                name = rec.record_name()
                payload = self.fetch_stage.call(
                    "read", lambda: self.disk.read(name),
                    path=self.disk.path(name))

            def _pagein():
                crc = zlib.crc32(payload) & 0xFFFFFFFF
                if len(payload) != rec.nbytes or crc != rec.crc:
                    raise KVTierCorruptError(
                        "parked page failed its host CRC check: "
                        f"stored ({rec.crc}, {rec.nbytes}B), got "
                        f"({crc}, {len(payload)}B)")
                self.importer(page, payload)

            self.fetch_stage.call("pagein", _pagein,
                                  path=f"page={page}")
        except KVTierCorruptError as e:
            self.pool.deref(page)
            self._remove(rec)
            self.corrupt_total += 1
            logger.error(
                "kv tier: parked page failed verification — dropping "
                "the record; resume falls back to recompute-from-"
                "prompt: %s", e)
            return False
        except OSError as e:
            self.pool.deref(page)
            self._remove(rec)
            logger.error(
                "kv tier: fetch failed (%r) — dropping the record; "
                "resume falls back to recompute-from-prompt", e)
            return False
        except BaseException:
            self.pool.deref(page)
            raise
        self.fetch_bytes += rec.nbytes
        self._remove(rec)
        pages.append(page)
        return True

    # -- record bookkeeping ----------------------------------------------
    def _remove(self, rec: _Parked) -> None:
        """Consume/drop one record: index removal, host accounting,
        best-effort disk cleanup.  Idempotent."""
        if rec.dead:
            return
        rec.dead = True
        if rec.payload is not None:
            rec.payload = None
            self._host_pages -= 1
        if rec.kind == "partial":
            bucket = self._partials.get(rec.key)
            if bucket is not None and bucket.get(rec.tokens) is rec:
                del bucket[rec.tokens]
                if not bucket:
                    del self._partials[rec.key]
        elif self._full.get(rec.key) is rec:
            del self._full[rec.key]
        if rec.on_disk and self.disk is not None:
            self.disk.remove(rec.record_name())

    # -- close plane -------------------------------------------------------
    def close_spill(self) -> None:
        """Stop parking (the ``kv_spill`` graph close) — resume keeps
        working on whatever is already parked."""
        self._closed = True

    def close(self) -> None:
        """Drop every parked record (the ``kv_fetch`` graph close).
        Records hold host/disk bytes only — no pool refs to return."""
        self._closed = True
        for rec in list(self._full.values()):
            self._remove(rec)
        for bucket in list(self._partials.values()):
            for rec in list(bucket.values()):
                self._remove(rec)
        self._full.clear()
        self._partials.clear()
        self._host.clear()
        self._host_pages = 0
        self._seen.clear()
