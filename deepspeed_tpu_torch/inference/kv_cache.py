"""Slot-based and page-pooled KV caches: the device state of serving.

Port of ``deepspeed_tpu/inference/kv_cache.py``: the two layouts and
their placement over a serving mesh (``ServeEngine(mesh=...)``): slots,
or pool pages, split over ``data`` and heads over ``model``, the scale
sidecars as their pools, ``lengths`` whole on every rank.  A "sharding"
here is a :class:`~..parallel.mesh.RankSharding`, the slice of each
tensor a rank of the mesh holds on its own device.

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
from typing import Dict, Optional

import torch

from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, RankSharding


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


def _zeros(shape, dtype, device, sharding: Optional[RankSharding]):
    """Zeros of this rank's slice of ``shape`` (the whole without a
    sharding)."""
    if sharding is not None:
        shape = sharding.shard_shape(shape)
    return torch.zeros(shape, dtype=dtype, device=device)


def init_cache(spec: KVCacheSpec, device=None,
               shardings: Optional[Dict[str, RankSharding]] = None
               ) -> Dict[str, torch.Tensor]:
    """Fresh all-free cache on ``device``; with ``shardings``
    (:func:`cache_shardings`) only this rank's slice of each leaf."""
    sh = shardings or {}
    shape = (spec.layers, spec.slots, spec.heads, spec.max_len,
             spec.head_dim)
    return {
        "k": _zeros(shape, spec.dtype, device, sh.get("k")),
        "v": _zeros(shape, spec.dtype, device, sh.get("v")),
        "lengths": torch.zeros((spec.slots,), dtype=torch.int32,
                               device=device),
    }


def cache_partition_specs() -> Dict[str, tuple]:
    """Partition specs for the slot cache: slots on ``data``, heads on
    ``model`` (matching the models' Megatron qkv column split)."""
    kv = (None, DATA_AXIS, MODEL_AXIS, None, None)
    return {"k": kv, "v": kv, "lengths": ()}


def cache_shardings(mesh: Mesh) -> Dict[str, RankSharding]:
    return {name: RankSharding(mesh, spec)
            for name, spec in cache_partition_specs().items()}


def _validate_tp_and_axes(mesh: Mesh, heads: int, what: str) -> None:
    """The checks both cache layouts share: TP-divisible heads and a
    strictly (data, model) mesh — fail at build time with the real
    story, not as a shape error mid-serve."""
    tp = mesh.shape.get(MODEL_AXIS, 1)
    if heads % tp != 0:
        raise ValueError(
            f"model heads={heads} must be divisible by the mesh's "
            f"model axis ({tp}) to TP-shard the {what}")
    for axis in ("pipe", "seq"):
        if mesh.shape.get(axis, 1) != 1:
            raise ValueError(
                f"the serving engine does not shard over the {axis!r} "
                f"axis (mesh has {axis}={mesh.shape[axis]}); serve on a "
                "(data, model) mesh")


def validate_cache_mesh(mesh: Mesh, spec: KVCacheSpec) -> None:
    dp = mesh.shape.get(DATA_AXIS, 1)
    if spec.slots % dp != 0:
        raise ValueError(
            f"serving.slots={spec.slots} must be divisible by the mesh's "
            f"data axis ({dp}): slots are the replica-sharded batch "
            "dimension of the decode program")
    _validate_tp_and_axes(mesh, spec.heads, "KV cache")


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


def init_paged_cache(spec: PagedKVCacheSpec, device=None,
                     shardings: Optional[Dict[str, RankSharding]] = None
                     ) -> Dict[str, torch.Tensor]:
    """Fresh all-free paged pool on ``device`` (reference
    ``kv_cache.py:169-186``); with ``shardings``
    (:func:`paged_cache_shardings`) only this rank's slice of each leaf.
    An int8 pool gets all-zero scale sidecars: a never-written row
    dequantizes to exact zeros."""
    sh = shardings or {}
    shape = (spec.layers, spec.pages, spec.heads, spec.page_len,
             spec.head_dim)
    cache = {
        "k": _zeros(shape, spec.dtype, device, sh.get("k")),
        "v": _zeros(shape, spec.dtype, device, sh.get("v")),
        "lengths": torch.zeros((spec.slots,), dtype=torch.int32,
                               device=device),
    }
    if spec.quant:
        for key in ("k_scale", "v_scale"):
            cache[key] = _zeros(shape[:-1], torch.float32, device,
                                sh.get(key))
    return cache


def paged_partition_specs(quant: bool = False) -> Dict[str, tuple]:
    """Pool pages on ``data``, heads on ``model`` — the page pool is the
    DP-sharded storage dimension the way slots were.  The quant scale
    sidecars shard exactly like their pools (minus the row dim's trailing
    head_dim)."""
    kv = (None, DATA_AXIS, MODEL_AXIS, None, None)
    specs = {"k": kv, "v": kv, "lengths": ()}
    if quant:
        sc = (None, DATA_AXIS, MODEL_AXIS, None)
        specs["k_scale"] = sc
        specs["v_scale"] = sc
    return specs


def paged_cache_shardings(mesh: Mesh, quant: bool = False
                          ) -> Dict[str, RankSharding]:
    return {name: RankSharding(mesh, spec)
            for name, spec in paged_partition_specs(quant).items()}


def validate_paged_cache_mesh(mesh: Mesh, spec: PagedKVCacheSpec) -> None:
    dp = mesh.shape.get(DATA_AXIS, 1)
    if spec.pages % dp != 0:
        raise ValueError(
            f"serving.pages={spec.pages} must be divisible by the "
            f"mesh's data axis ({dp}): the page pool is the DP-sharded "
            "storage dimension of the decode program")
    _validate_tp_and_axes(mesh, spec.heads, "KV page pool")


def shard_cache(cache: Dict[str, torch.Tensor], mesh: Mesh,
                shardings: Optional[Dict[str, RankSharding]] = None
                ) -> Dict[str, torch.Tensor]:
    """This rank's slice of each leaf of a whole cache (either layout;
    default shardings: the slot cache's).  The engine allocates its
    slices directly (``init_cache``/``init_paged_cache`` with
    ``shardings``); this places a cache built whole."""
    if shardings is None:
        shardings = cache_shardings(mesh)
    return {name: shardings[name].piece(t) for name, t in cache.items()}
