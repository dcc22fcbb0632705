"""Slot-based and page-pooled KV caches: the device state of serving.

Port of ``deepspeed_tpu/inference/kv_cache.py``'s two layouts (the mesh
shardings are not ported: the port serves on one device).

**Slot cache** — one fixed stride per slot:

    k, v     [L, S, H, T, Dh]   layer-major, slot-batched
    lengths  [S] int32          per-slot LIVE length (0 = free slot)

**Paged cache** (``serving.page_len > 0``) — a flat pool of fixed-size
pages plus host-owned page tables:

    k, v     [L, P, H, page_len, Dh]   layer-major, page-pooled
    lengths  [S] int32                 per-slot LIVE length

A slot's KV rows live wherever its int32 page table points; page 0 is the
reserved scratch page masked writes land on.  A short request holds
ceil(len/page_len) pages instead of a full ``max_seq_len`` stride.  Only
the fp pool is ported: the int8 pool and its scale sidecars are ROADMAP.md
queue 1 item 7.4.

The shapes never change for the life of the engine: admission writes a
prefilled request's K/V rows in place, decode appends one row per tick,
eviction is host bookkeeping (page frees, masked stale rows).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


@dataclasses.dataclass(frozen=True)
class KVCacheSpec:
    layers: int
    slots: int
    heads: int
    max_len: int
    head_dim: int
    dtype: torch.dtype = torch.float32

    @property
    def bytes(self) -> int:
        return (2 * self.layers * self.slots * self.heads * self.max_len
                * self.head_dim * _itemsize(self.dtype))


def init_cache(spec: KVCacheSpec, device=None) -> Dict[str, torch.Tensor]:
    """Fresh all-free cache on ``device``."""
    shape = (spec.layers, spec.slots, spec.heads, spec.max_len,
             spec.head_dim)
    return {
        "k": torch.zeros(shape, dtype=spec.dtype, device=device),
        "v": torch.zeros(shape, dtype=spec.dtype, device=device),
        "lengths": torch.zeros((spec.slots,), dtype=torch.int32,
                               device=device),
    }


@dataclasses.dataclass(frozen=True)
class PagedKVCacheSpec:
    """The flat page pool (reference ``kv_cache.py:121-166``): ``pages``
    fixed-size pages of ``page_len`` tokens each (page 0 reserved as the
    scratch page), referenced by per-slot page tables the host owns.
    ``quant`` (the int8 pool) must stay False: it is not ported."""
    layers: int
    slots: int
    heads: int
    pages: int
    page_len: int
    head_dim: int
    #: table width: pages a slot can reference (ceil(max_len/page_len))
    max_pages: int
    dtype: torch.dtype = torch.float32
    quant: bool = False

    def __post_init__(self):
        if self.quant:
            raise NotImplementedError(
                "PagedKVCacheSpec(quant=True) (the int8 page pool) is not "
                "ported to deepspeed_tpu_torch yet: ROADMAP.md queue 1, item "
                "7.4 (quantized serving)")

    @property
    def bytes(self) -> int:
        return self.pages * self.page_bytes

    @property
    def page_bytes(self) -> int:
        """Device bytes of ONE page across layers and both of k/v."""
        return (2 * self.layers * self.heads * self.page_len
                * self.head_dim * _itemsize(self.dtype))


def init_paged_cache(spec: PagedKVCacheSpec,
                     device=None) -> Dict[str, torch.Tensor]:
    """Fresh all-free paged pool on ``device`` (reference
    ``kv_cache.py:169-186``, fp pool)."""
    shape = (spec.layers, spec.pages, spec.heads, spec.page_len,
             spec.head_dim)
    return {
        "k": torch.zeros(shape, dtype=spec.dtype, device=device),
        "v": torch.zeros(shape, dtype=spec.dtype, device=device),
        "lengths": torch.zeros((spec.slots,), dtype=torch.int32,
                               device=device),
    }
