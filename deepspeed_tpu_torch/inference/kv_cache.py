"""Slot KV cache: the device state of serving (unpaged layout).

Port of ``deepspeed_tpu/inference/kv_cache.py``'s slot cache — one fixed
stride per slot:

    k, v     [L, S, H, T, Dh]   layer-major, slot-batched
    lengths  [S] int32          per-slot LIVE length (0 = free slot)

The shapes never change for the life of the engine: admission writes a
prefilled request's K/V rows in place, decode appends one row per tick,
eviction is host bookkeeping (stale rows are masked by length).  The paged
pool and the mesh shardings are not ported yet (ROADMAP.md queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch


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
        per = torch.empty((), dtype=self.dtype).element_size()
        return (2 * self.layers * self.slots * self.heads * self.max_len
                * self.head_dim * per)


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
