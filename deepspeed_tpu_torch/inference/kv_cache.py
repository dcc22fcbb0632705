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
ceil(len/page_len) pages instead of a full ``max_seq_len`` stride.  The
int8 pool (``serving.quantization.kv='int8'``) stores int8 rows plus fp32
scale sidecars:

    k_scale, v_scale  [L, P, H, page_len] fp32   one scale per stored row

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

    ``quant`` (``serving.quantization.kv='int8'``): the pool stores int8
    rows (``dtype`` int8) plus a fp32 scale sidecar ``[L, pages, H,
    page_len]`` per pool; ``bytes`` and ``page_bytes`` count the sidecars,
    as the reference's do."""
    layers: int
    slots: int
    heads: int
    pages: int
    page_len: int
    head_dim: int
    #: table width: pages a slot can reference (ceil(max_len/page_len))
    max_pages: int
    dtype: torch.dtype = torch.float32
    #: int8 rows + per-(page, head, row) fp32 scale sidecars
    quant: bool = False

    @property
    def bytes(self) -> int:
        return self.pages * self.page_bytes

    @property
    def page_bytes(self) -> int:
        """Device bytes of ONE page across layers and both of k/v, the
        scale sidecar rows included."""
        per_row = self.head_dim * _itemsize(self.dtype) + (
            4 if self.quant else 0)
        return 2 * self.layers * self.heads * self.page_len * per_row


def init_paged_cache(spec: PagedKVCacheSpec,
                     device=None) -> Dict[str, torch.Tensor]:
    """Fresh all-free paged pool on ``device`` (reference
    ``kv_cache.py:169-186``).  An int8 pool gets all-zero scale sidecars:
    a never-written row dequantizes to exact zeros."""
    shape = (spec.layers, spec.pages, spec.heads, spec.page_len,
             spec.head_dim)
    cache = {
        "k": torch.zeros(shape, dtype=spec.dtype, device=device),
        "v": torch.zeros(shape, dtype=spec.dtype, device=device),
        "lengths": torch.zeros((spec.slots,), dtype=torch.int32,
                               device=device),
    }
    if spec.quant:
        for key in ("k_scale", "v_scale"):
            cache[key] = torch.zeros(shape[:-1], dtype=torch.float32,
                                     device=device)
    return cache
