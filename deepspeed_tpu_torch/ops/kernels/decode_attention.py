"""Decode attention over the serving KV caches: the hand-written Hopper
kernels, their plain PyTorch versions and the dense references.

Port of ``deepspeed_tpu/ops/pallas/decode_attention.py``: the four entry
points and the four kernels they launch (entry point: CUDA source, TPU
kernel it replaces):

- ``decode_attention``: ``csrc/decode_attention.cu``, ``_decode_kernel``;
- ``decode_attention_paged``: ``csrc/decode_paged.cu``,
  ``_decode_paged_kernel`` (both arms: ``decode_paged`` for the fp pool,
  ``decode_paged_int8`` for the int8 pool);
- ``decode_attention_multi``: ``csrc/decode_multi.cu``,
  ``_decode_multi_kernel``;
- ``decode_attention_paged_multi``: ``csrc/decode_paged_multi.cu``,
  ``_decode_paged_multi_kernel`` (``decode_paged_multi`` and
  ``decode_paged_multi_int8``).

The bf16/fp16 arms of the last three are one kernel
(``csrc/decode_split.cuh``) with two maps from a key to its row: the slot
cache's, or the page table's.  It splits each (slot, head)'s keys over a
thread-block cluster (``decode_splits``) and runs the products on the
tensor cores; their fp32 arms run ``csrc/decode_common.cuh``'s FMA
kernel.

The single-query arms take one query per slot (a decode tick); the multi
arms take W = k+1 queries per slot with per-query lengths ``[S, W]`` (the
speculative verify pass).  The paged arms read the K/V rows of slot ``s``
through its page table: position ``p`` is row ``p % page_len`` of page
``page_table[s, p // page_len]`` of a flat pool ``[P, H, page_len, Dh]``;
table entries past a slot's live pages are never read (the engine keeps
them at the scratch page 0).

``impl`` keeps the JAX package's config values: ``"pallas"`` is the
hand-written kernel on a CUDA tensor and its plain version on a CPU
tensor; ``"dense"`` is the dense reference on either.  There is no
fallback: with ``impl="pallas"`` a CUDA tensor reaches the kernel or the
call raises.

The int8 pool (``serving.quantization.kv='int8'``): the paged arms take
int8 pools with fp32 ``k_scale``/``v_scale`` sidecars ``[P, H,
page_len]``, one scale per stored row.  What a quantized page means is
:func:`dequantize_paged` (``int8 * its row scale``); the dense arm runs the
dense reference over that view, the plain versions the plain attention
over it, and the kernels fold the scales into the scores and
probabilities without dequantizing the page.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from . import build
from .flash_attention import _DTYPE_CODES, HEAD_DIM

#: the largest W the multi-query kernels take (speculate_k <= 8)
MAX_W = 9


def _default_scale(d: int) -> float:
    """1/sqrt(d) computed in fp32 — the exact constant the dense attention
    uses (the python-float ``d ** -0.5`` can differ by 1 ulp)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


# ---------------------------------------------------------------------------
# dense references (the JAX package's impl="dense" arms)
# ---------------------------------------------------------------------------


def decode_attention_reference(q, k, v, lengths, sm_scale=None):
    """Dense reference: q [S, H, Dh] against k/v [S, H, T, Dh] masked to
    per-slot ``lengths`` [S].  Rows with length 0 return exact zeros.
    Mirrors the JAX package's reference op for op (fp32 scores, finfo.min
    mask fill, softmax, probs cast to q.dtype before the value product,
    the output in the promoted type of q and v)."""
    S, H, T, Dh = k.shape
    scale = _default_scale(Dh) if sm_scale is None else sm_scale
    s = torch.einsum("shd,shtd->sht", q.float(), k.float()) * scale
    lengths = lengths.to(device=k.device, dtype=torch.int32)
    valid = (torch.arange(T, device=k.device, dtype=torch.int32)[None, None]
             < lengths[:, None, None])
    s = torch.where(valid, s, torch.finfo(torch.float32).min)
    probs = torch.softmax(s, dim=-1)
    probs = torch.where(lengths[:, None, None] > 0, probs, 0.0)
    # the probabilities round to q.dtype, then the product takes JAX's
    # promotion of q.dtype and v.dtype: a dequantized (fp32) cache under a
    # bf16 query gives fp32, as the reference's dense arm does (the kernel
    # arms return q.dtype in both packages)
    out_dt = torch.promote_types(q.dtype, v.dtype)
    return torch.einsum("sht,shtd->shd", probs.to(q.dtype).to(out_dt),
                        v.to(out_dt))


def decode_attention_multi_reference(q, k, v, lengths, sm_scale=None):
    """W stacked single-query references (``deepspeed_tpu/ops/pallas/
    decode_attention.py:502-514``): ``q [S, H, W, Dh]`` against ``k/v [S,
    H, T, Dh]`` with per-query ``lengths [S, W]``; query ``i`` is exactly
    ``decode_attention_reference(q[:, :, i], ..., lengths[:, i])``."""
    return torch.stack([decode_attention_reference(
        q[:, :, i], k, v, lengths[:, i], sm_scale=sm_scale)
        for i in range(q.shape[2])], dim=2)


def paged_gather(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """A slot-major dense view of the page pool (``deepspeed_tpu/ops/
    pallas/decode_attention.py:243-255``): ``pool [P, H, page_len, Dh]``
    gathered through ``page_table [S, max_pages]`` -> ``[S, H,
    max_pages*page_len, Dh]``; position ``p`` of slot ``s`` is row ``p %
    page_len`` of page ``page_table[s, p // page_len]``."""
    g = pool[page_table.long()]                     # [S, M, H, L, Dh]
    S, M, H, L, Dh = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(S, H, M * L, Dh)


def paged_gather_scales(scales: torch.Tensor,
                        page_table: torch.Tensor) -> torch.Tensor:
    """The scale-sidecar twin of :func:`paged_gather` (``decode_attention.
    py:258-267``): ``scales [P, H, page_len]`` -> ``[S, H,
    max_pages*page_len]``."""
    g = scales[page_table.long()]                   # [S, M, H, L]
    S, M, H, L = g.shape
    return g.permute(0, 2, 1, 3).reshape(S, H, M * L)


def dequantize_paged(pool: torch.Tensor, scales: torch.Tensor,
                     page_table: torch.Tensor) -> torch.Tensor:
    """Gather and dequantize an int8 pool (``decode_attention.py:
    269-277``): what a quantized page means, ``int8 * its row scale``, in
    fp32 — the definition the int8 kernel arms are checked against."""
    from ...inference.quantize import dequantize_rows
    return dequantize_rows(paged_gather(pool, page_table),
                           paged_gather_scales(scales, page_table))


def _check_quant_args(k_pages, k_scale, v_scale, what: str) -> None:
    """The reference's fused-dequant contract (``decode_attention.py:
    421-431``): the two scale sidecars come together and only over an
    int8 pool."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError(
            f"{what}: k_scale and v_scale must be passed together "
            "(the fused-dequant arm scales both pools)")
    if k_scale is not None and k_pages.dtype != torch.int8:
        raise ValueError(
            f"{what}: scale operands imply an int8 page pool, got "
            f"dtype {k_pages.dtype}")


# ---------------------------------------------------------------------------
# plain versions: each kernel's function in plain PyTorch
# ---------------------------------------------------------------------------


def decode_multi_plain(q, k, v, lengths, sm_scale: float):
    """``csrc/decode_multi.cu``'s function in plain PyTorch: q [S, H, W,
    Dh] against k/v [S, H, T, Dh], query ``w`` of slot ``s`` over the keys
    ``[0, lengths[s, w])``; fp32 scores, softmax and value product; exact
    zeros for a length-0 row; output in q.dtype."""
    S, H, T, Dh = k.shape
    s = torch.einsum("shwd,shtd->shwt", q.float(), k.float()) * sm_scale
    lengths = lengths.to(device=k.device, dtype=torch.int64)
    valid = (torch.arange(T, device=k.device)[None, None, None]
             < lengths[:, None, :, None])
    s = torch.where(valid, s, float("-inf"))
    live = (lengths > 0)[:, None, :, None]
    m = torch.where(live, s.amax(dim=-1, keepdim=True), 0.0)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("shwt,shtd->shwd", p, v.float()) / torch.where(
        live, l, 1.0)
    return out.to(q.dtype)


def decode_attention_plain(q, k, v, lengths, sm_scale: float):
    """``csrc/decode_attention.cu``'s function in plain PyTorch: the
    one-row case of :func:`decode_multi_plain` (q [S, H, Dh], lengths
    [S])."""
    return decode_multi_plain(q[:, :, None], k, v, lengths.reshape(-1, 1),
                              sm_scale)[:, :, 0]


def _live_table(page_table, lengths, page_len: int):
    """The table with every column at or past ``ceil(max row length /
    page_len)`` set to the scratch page 0: the columns the kernels never
    read.  ``lengths`` is [S] or [S, W]."""
    lens = lengths.reshape(lengths.shape[0], -1).amax(dim=1).clamp(min=0)
    need = (lens.long() + page_len - 1) // page_len
    cols = torch.arange(page_table.shape[1], device=page_table.device)
    return torch.where(cols[None] < need[:, None].to(page_table.device),
                       page_table.long(), 0)


def decode_paged_plain(q, k_pages, v_pages, page_table, lengths,
                       sm_scale: float):
    """``csrc/decode_paged.cu``'s function in plain PyTorch: the live
    pages gathered through the table, then :func:`decode_attention_plain`."""
    table = _live_table(page_table, lengths, k_pages.shape[2])
    return decode_attention_plain(q, paged_gather(k_pages, table),
                                  paged_gather(v_pages, table), lengths,
                                  sm_scale)


def decode_paged_multi_plain(q, k_pages, v_pages, page_table, lengths,
                             sm_scale: float):
    """``csrc/decode_paged_multi.cu``'s function in plain PyTorch: the
    pages live for the longest row gathered, then
    :func:`decode_multi_plain`."""
    table = _live_table(page_table, lengths, k_pages.shape[2])
    return decode_multi_plain(q, paged_gather(k_pages, table),
                              paged_gather(v_pages, table), lengths,
                              sm_scale)


def _dequant_live(pool, scales, page_table, lengths):
    """The int8 pool dequantized through the live table (fp32 ``[S, H,
    max_pages*page_len, Dh]``), every row at or past the slot's longest
    length set to 0: the rows the kernels never read, whose bytes and
    scales may be anything (a NaN scale included)."""
    S = page_table.shape[0]
    table = _live_table(page_table, lengths, pool.shape[2])
    g = dequantize_paged(pool, scales, table)
    lens = lengths.reshape(S, -1).amax(dim=1).to(g.device)
    keep = torch.arange(g.shape[2], device=g.device)[None] < lens[:, None]
    return torch.where(keep[:, None, :, None], g, 0.0)


def decode_paged_int8_plain(q, k_pages, v_pages, k_scale, v_scale,
                            page_table, lengths, sm_scale: float):
    """``csrc/decode_paged.cu``'s int8 arm in plain PyTorch: the live
    pages dequantized (:func:`dequantize_paged`), then
    :func:`decode_attention_plain`."""
    return decode_attention_plain(
        q, _dequant_live(k_pages, k_scale, page_table, lengths),
        _dequant_live(v_pages, v_scale, page_table, lengths), lengths,
        sm_scale)


def decode_paged_multi_int8_plain(q, k_pages, v_pages, k_scale, v_scale,
                                  page_table, lengths, sm_scale: float):
    """``csrc/decode_paged_multi.cu``'s int8 arm in plain PyTorch: the
    pages live for the longest row dequantized, then
    :func:`decode_multi_plain`."""
    return decode_multi_plain(
        q, _dequant_live(k_pages, k_scale, page_table, lengths),
        _dequant_live(v_pages, v_scale, page_table, lengths), lengths,
        sm_scale)


# ---------------------------------------------------------------------------
# the CUDA launchers
# ---------------------------------------------------------------------------

_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: the C signature of each launcher after its pointers: ints, sm_scale,
#: dtype code, stream
_SIGNATURES = {
    # q k v lengths o | slots heads t_max
    "decode_attention": (5, 3),
    # q k v table lengths o | slots heads pages page_len max_pages
    "decode_paged": (6, 5),
    # q k v lengths o | slots heads w t_max
    "decode_multi": (5, 4),
    # q k v table lengths o | slots heads w pages page_len max_pages
    "decode_paged_multi": (6, 6),
    # q k8 v8 k_scale v_scale table lengths o | as decode_paged
    "decode_paged_int8": (8, 5),
    # q k8 v8 k_scale v_scale table lengths o | as decode_paged_multi
    "decode_paged_multi_int8": (8, 6),
}
#: the source each launcher is built from (default: its own name)
_SOURCES = {"decode_paged_int8": "decode_paged",
            "decode_paged_multi_int8": "decode_paged_multi"}


def _load(name: str):
    lib = build.load(_SOURCES.get(name, name))
    fn = getattr(lib, name)
    if fn.argtypes is None:
        n_ptr, n_int = _SIGNATURES[name]
        fn.argtypes = ([_PTR] * n_ptr + [_INT] * n_int
                       + [_FLOAT, _INT, _PTR])
        fn.restype = ctypes.c_int
    return fn


def _check_operands(what: str, q, floats, ints, typed=None) -> None:
    """Device, contiguity, alignment and dtype checks every launcher
    shares: ``floats`` share q's dtype, ``ints`` are int32, ``typed``
    maps a name to ``(tensor, the dtype it must have)``."""
    typed = typed or {}
    for name, t in (list(floats.items()) + list(ints.items())
                    + [(n, t) for n, (t, _) in typed.items()]):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{what}: {name} is on {t.device}; all "
                             "operands must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
        # the scales are read one fp32 at a time, everything else in
        # 8- or 16-byte vectors
        align = 4 if name.endswith("_scale") else 16
        if t.data_ptr() % align:
            raise ValueError(f"{what}: {name} is not {align}-byte aligned")
    for name, t in floats.items():
        if t.dtype != q.dtype or t.dtype not in _DTYPE_CODES:
            raise TypeError(f"{what}: {name} has dtype {t.dtype}; q, k and "
                            f"v must share one of {list(_DTYPE_CODES)}")
    for name, t in ints.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{what}: {name} must be int32, got {t.dtype}")
    for name, (t, dtype) in typed.items():
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} must be {dtype}, got {t.dtype}")


def _launch(name: str, q, ptrs, ints, sm_scale: float) -> torch.Tensor:
    """Allocate the output, launch ``name`` on the current stream and
    raise if the launch failed.  ``ptrs`` are the input tensors in the C
    order (the output pointer follows them)."""
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = _load(name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(*(t.data_ptr() for t in ptrs), out.data_ptr(), *ints,
                float(sm_scale), _DTYPE_CODES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    return out


def _shape_error(what, want, **shapes):
    got = ", ".join(f"{n} {tuple(s)}" for n, s in shapes.items())
    return ValueError(f"{what}: shapes {got}; the kernel takes {want}")


def decode_attention_cuda(q, k, v, lengths, sm_scale: float):
    """Launch ``csrc/decode_attention.cu`` on contiguous CUDA tensors q
    [S,H,64], k/v [S,H,T,64] of one dtype (fp32, bf16 or fp16) and int32
    lengths [S].  The lengths stay on the device (no host sync).  bf16
    and fp16 split each (slot, head)'s keys over a cluster of
    ``decode_splits(T, S * H)`` CUDA blocks; fp32 runs one block per
    (slot, head).  Returns the output [S,H,64] in q.dtype; raises on
    anything the kernel does not take and on a failed launch."""
    what = "decode_attention_cuda"
    _check_operands(what, q, {"q": q, "k": k, "v": v}, {"lengths": lengths})
    S, H, T, Dh = k.shape
    if (Dh != HEAD_DIM or q.shape != (S, H, Dh) or v.shape != k.shape
            or lengths.shape != (S,)):
        raise _shape_error(what, f"q [S, H, {HEAD_DIM}], k/v [S, H, T, "
                           f"{HEAD_DIM}], lengths [S]", q=q.shape,
                           k=k.shape, v=v.shape, lengths=lengths.shape)
    out = _launch("decode_attention", q, (q, k, v, lengths), (S, H, T),
                  sm_scale)
    decode_attention.launches += 1
    return out


def decode_paged_cuda(q, k_pages, v_pages, page_table, lengths,
                      sm_scale: float):
    """Launch ``csrc/decode_paged.cu``: q [S,H,64], pools [P,H,page_len,64]
    (page_len 1..128), int32 page_table [S, max_pages] and lengths [S],
    all on the device.  Live table entries must name pages below P.  bf16
    and fp16 split each (slot, head)'s keys over a cluster of
    ``decode_splits(max_pages * page_len, S * H)`` CUDA blocks; fp32
    runs one block per (slot, head)."""
    what = "decode_paged_cuda"
    _check_operands(what, q, {"q": q, "k_pages": k_pages,
                              "v_pages": v_pages},
                    {"page_table": page_table, "lengths": lengths})
    P, H, L, Dh = k_pages.shape
    S, M = page_table.shape
    if (Dh != HEAD_DIM or q.shape != (S, H, Dh) or v_pages.shape
            != k_pages.shape or lengths.shape != (S,) or not 1 <= L <= 128):
        raise _shape_error(what, f"q [S, H, {HEAD_DIM}], pools [P, H, "
                           f"page_len <= 128, {HEAD_DIM}], page_table [S, "
                           "max_pages], lengths [S]", q=q.shape,
                           k_pages=k_pages.shape, v_pages=v_pages.shape,
                           page_table=page_table.shape,
                           lengths=lengths.shape)
    out = _launch("decode_paged", q, (q, k_pages, v_pages, page_table,
                                      lengths), (S, H, P, L, M), sm_scale)
    decode_attention_paged.launches += 1
    return out


def decode_multi_cuda(q, k, v, lengths, sm_scale: float):
    """Launch ``csrc/decode_multi.cu``: q [S,H,W,64] (W <= 9), k/v
    [S,H,T,64], int32 per-query lengths [S, W], all on the device.  bf16
    and fp16 split each (slot, head)'s keys over a cluster of
    ``decode_splits(T, S * H)`` CUDA blocks; fp32 runs one block per
    (slot, head)."""
    what = "decode_multi_cuda"
    _check_operands(what, q, {"q": q, "k": k, "v": v}, {"lengths": lengths})
    S, H, T, Dh = k.shape
    W = q.shape[2] if q.ndim == 4 else 0
    if (Dh != HEAD_DIM or q.shape != (S, H, W, Dh) or v.shape != k.shape
            or lengths.shape != (S, W) or not 1 <= W <= MAX_W):
        raise _shape_error(what, f"q [S, H, W <= {MAX_W}, {HEAD_DIM}], k/v "
                           f"[S, H, T, {HEAD_DIM}], lengths [S, W]",
                           q=q.shape, k=k.shape, v=v.shape,
                           lengths=lengths.shape)
    out = _launch("decode_multi", q, (q, k, v, lengths), (S, H, W, T),
                  sm_scale)
    decode_attention_multi.launches += 1
    return out


def decode_splits(t_max: int, pairs: int = 1) -> int:
    """CUDA blocks per (slot, head), which is also the cluster size, of
    the bf16/fp16 kernel of ``csrc/decode_attention.cu``,
    ``csrc/decode_multi.cu``, ``csrc/decode_paged.cu`` and
    ``csrc/decode_paged_multi.cu`` at cache length ``t_max`` (T, or
    max_pages x page_len) over ``pairs`` = slots x heads: the launchers'
    own count (``decode_split.cuh``'s ``splits``), read from the built
    ``decode_multi`` library."""
    fn = build.load("decode_multi").decode_splits
    fn.argtypes, fn.restype = [_INT, _INT], ctypes.c_int
    return int(fn(int(t_max), int(pairs)))


def decode_paged_multi_cuda(q, k_pages, v_pages, page_table, lengths,
                            sm_scale: float):
    """Launch ``csrc/decode_paged_multi.cu``: q [S,H,W,64] (W <= 9), pools
    [P,H,page_len,64] (page_len 1..128), int32 page_table [S, max_pages]
    and per-query lengths [S, W], all on the device; bf16 and fp16 split
    the keys as :func:`decode_paged_cuda` does."""
    what = "decode_paged_multi_cuda"
    _check_operands(what, q, {"q": q, "k_pages": k_pages,
                              "v_pages": v_pages},
                    {"page_table": page_table, "lengths": lengths})
    P, H, L, Dh = k_pages.shape
    S, M = page_table.shape
    W = q.shape[2] if q.ndim == 4 else 0
    if (Dh != HEAD_DIM or q.shape != (S, H, W, Dh) or v_pages.shape
            != k_pages.shape or lengths.shape != (S, W)
            or not 1 <= W <= MAX_W or not 1 <= L <= 128):
        raise _shape_error(what, f"q [S, H, W <= {MAX_W}, {HEAD_DIM}], "
                           f"pools [P, H, page_len <= 128, {HEAD_DIM}], "
                           "page_table [S, max_pages], lengths [S, W]",
                           q=q.shape, k_pages=k_pages.shape,
                           v_pages=v_pages.shape,
                           page_table=page_table.shape,
                           lengths=lengths.shape)
    out = _launch("decode_paged_multi", q, (q, k_pages, v_pages, page_table,
                                            lengths), (S, H, W, P, L, M),
                  sm_scale)
    decode_attention_paged_multi.launches += 1
    return out


def _check_int8_pools(what, q, k_pages, v_pages, k_scale, v_scale,
                      page_table, lengths):
    """The int8 arms' operand checks: q fp32/bf16/fp16, int8 pools, fp32
    scales [P, H, page_len], int32 table and lengths."""
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what}: q has dtype {q.dtype}; expected one of "
                        f"{list(_DTYPE_CODES)}")
    _check_operands(what, q, {"q": q}, {"page_table": page_table,
                                        "lengths": lengths},
                    {"k_pages": (k_pages, torch.int8),
                     "v_pages": (v_pages, torch.int8),
                     "k_scale": (k_scale, torch.float32),
                     "v_scale": (v_scale, torch.float32)})
    if (v_pages.shape != k_pages.shape or k_scale.shape != k_pages.shape[:3]
            or v_scale.shape != k_scale.shape):
        raise _shape_error(what, "int8 pools [P, H, page_len, 64] and fp32 "
                           "scales [P, H, page_len]", k_pages=k_pages.shape,
                           v_pages=v_pages.shape, k_scale=k_scale.shape,
                           v_scale=v_scale.shape)


def decode_paged_int8_cuda(q, k_pages, v_pages, k_scale, v_scale,
                           page_table, lengths, sm_scale: float):
    """Launch ``csrc/decode_paged.cu``'s int8 arm: q [S,H,64] (fp32, bf16
    or fp16), int8 pools [P,H,page_len,64] (page_len 1..128), fp32
    k_scale/v_scale [P,H,page_len], int32 page_table [S, max_pages] and
    lengths [S], all on the device.  Output in q.dtype."""
    what = "decode_paged_int8_cuda"
    _check_int8_pools(what, q, k_pages, v_pages, k_scale, v_scale,
                      page_table, lengths)
    P, H, L, Dh = k_pages.shape
    S, M = page_table.shape
    if (Dh != HEAD_DIM or q.shape != (S, H, Dh) or lengths.shape != (S,)
            or not 1 <= L <= 128):
        raise _shape_error(what, f"q [S, H, {HEAD_DIM}], pools [P, H, "
                           f"page_len <= 128, {HEAD_DIM}], page_table [S, "
                           "max_pages], lengths [S]", q=q.shape,
                           k_pages=k_pages.shape,
                           page_table=page_table.shape,
                           lengths=lengths.shape)
    out = _launch("decode_paged_int8", q, (q, k_pages, v_pages, k_scale,
                                           v_scale, page_table, lengths),
                  (S, H, P, L, M), sm_scale)
    decode_attention_paged.launches_int8 += 1
    return out


def decode_paged_multi_int8_cuda(q, k_pages, v_pages, k_scale, v_scale,
                                 page_table, lengths, sm_scale: float):
    """Launch ``csrc/decode_paged_multi.cu``'s int8 arm: q [S,H,W,64] (W
    <= 9; fp32, bf16 or fp16), int8 pools [P,H,page_len,64], fp32
    k_scale/v_scale [P,H,page_len], int32 page_table [S, max_pages] and
    per-query lengths [S, W], all on the device."""
    what = "decode_paged_multi_int8_cuda"
    _check_int8_pools(what, q, k_pages, v_pages, k_scale, v_scale,
                      page_table, lengths)
    P, H, L, Dh = k_pages.shape
    S, M = page_table.shape
    W = q.shape[2] if q.ndim == 4 else 0
    if (Dh != HEAD_DIM or q.shape != (S, H, W, Dh)
            or lengths.shape != (S, W) or not 1 <= W <= MAX_W
            or not 1 <= L <= 128):
        raise _shape_error(what, f"q [S, H, W <= {MAX_W}, {HEAD_DIM}], "
                           f"pools [P, H, page_len <= 128, {HEAD_DIM}], "
                           "page_table [S, max_pages], lengths [S, W]",
                           q=q.shape, k_pages=k_pages.shape,
                           page_table=page_table.shape,
                           lengths=lengths.shape)
    out = _launch("decode_paged_multi_int8", q,
                  (q, k_pages, v_pages, k_scale, v_scale, page_table,
                   lengths), (S, H, W, P, L, M), sm_scale)
    decode_attention_paged_multi.launches_int8 += 1
    return out


# ---------------------------------------------------------------------------
# public entry points (the JAX package's signatures)
# ---------------------------------------------------------------------------


def _check_impl(what: str, impl: str) -> None:
    if impl not in ("pallas", "dense"):
        raise ValueError(f"{what} impl={impl!r}: expected 'pallas' or "
                         "'dense'")


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor,
                     sm_scale: Optional[float] = None,
                     impl: str = "pallas") -> torch.Tensor:
    """Single-query attention over a slot KV cache.

    q: [S, H, Dh] — one new query token per slot.
    k, v: [S, H, T, Dh] — the slot cache; positions >= lengths[s] are
        garbage and are hard-masked.
    lengths: [S] int — per-slot live KV length including the position
        this query's K/V was just written to.  0 = free slot → exact-zero
        output.

    ``impl``: ``'pallas'`` (the hand-written kernel on CUDA, its plain
    version on the CPU) or ``'dense'`` (the dense reference).
    """
    assert q.ndim == 3 and k.ndim == 4, (tuple(q.shape), tuple(k.shape))
    S, H, T, Dh = k.shape
    assert tuple(q.shape) == (S, H, Dh), (tuple(q.shape), tuple(k.shape))
    if sm_scale is None:
        sm_scale = _default_scale(Dh)
    _check_impl("decode_attention", impl)
    if impl == "dense":
        return decode_attention_reference(q, k, v, lengths,
                                          sm_scale=sm_scale)
    if q.is_cuda:
        return decode_attention_cuda(q.contiguous(), k.contiguous(),
                                     v.contiguous(), _i32(lengths), sm_scale)
    return decode_attention_plain(q, k, v, lengths, sm_scale)


def decode_attention_paged(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_table: torch.Tensor,
                           lengths: torch.Tensor,
                           sm_scale: Optional[float] = None,
                           impl: str = "pallas",
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Single-query attention over a paged KV pool (``deepspeed_tpu/ops/
    pallas/decode_attention.py:434-494``).

    q: [S, H, Dh]; k_pages, v_pages: [P, H, page_len, Dh];
    page_table: [S, max_pages] int — dead entries hold the scratch page 0;
    lengths: [S] int — live KV length including this query's position (0
    = free slot -> exact zeros);
    k_scale, v_scale: [P, H, page_len] fp32 — the int8 pool's per-row
    scales (the pools are then int8); None = the fp pool.

    ``impl='dense'`` gathers the pool (dequantized on the int8 arm) and
    runs :func:`decode_attention_reference`; ``'pallas'`` is the kernel on
    a CUDA tensor and its plain version on a CPU one."""
    assert q.ndim == 3 and k_pages.ndim == 4, (tuple(q.shape),
                                               tuple(k_pages.shape))
    P, H, page_len, Dh = k_pages.shape
    S = page_table.shape[0]
    assert tuple(q.shape) == (S, H, Dh), (tuple(q.shape),
                                          tuple(k_pages.shape))
    _check_quant_args(k_pages, k_scale, v_scale, "decode_attention_paged")
    if sm_scale is None:
        sm_scale = _default_scale(Dh)
    _check_impl("decode_attention_paged", impl)
    if k_scale is not None:
        if impl == "dense":
            return decode_attention_reference(
                q, dequantize_paged(k_pages, k_scale, page_table),
                dequantize_paged(v_pages, v_scale, page_table), lengths,
                sm_scale=sm_scale)
        if q.is_cuda:
            return decode_paged_int8_cuda(
                q.contiguous(), k_pages.contiguous(), v_pages.contiguous(),
                k_scale.float().contiguous(), v_scale.float().contiguous(),
                _i32(page_table), _i32(lengths), sm_scale)
        return decode_paged_int8_plain(q, k_pages, v_pages, k_scale, v_scale,
                                       page_table, lengths, sm_scale)
    if impl == "dense":
        return decode_attention_reference(
            q, paged_gather(k_pages, page_table),
            paged_gather(v_pages, page_table), lengths, sm_scale=sm_scale)
    if q.is_cuda:
        return decode_paged_cuda(q.contiguous(), k_pages.contiguous(),
                                 v_pages.contiguous(), _i32(page_table),
                                 _i32(lengths), sm_scale)
    return decode_paged_plain(q, k_pages, v_pages, page_table, lengths,
                              sm_scale)


def decode_attention_multi(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, lengths: torch.Tensor,
                           sm_scale: Optional[float] = None,
                           impl: str = "pallas") -> torch.Tensor:
    """Multi-query attention over the slot KV cache — the speculative
    verify pass (``deepspeed_tpu/ops/pallas/decode_attention.py:
    624-663``).

    q: [S, H, W, Dh] — the pending token and its k draft proposals;
    k, v: [S, H, T, Dh] with all W new rows already written;
    lengths: [S, W] int — per-query live length (row ``i`` of an active
    slot at base length L is ``L + i + 1``); 0 = masked row -> exact
    zeros."""
    assert q.ndim == 4 and k.ndim == 4, (tuple(q.shape), tuple(k.shape))
    S, H, T, Dh = k.shape
    W = q.shape[2]
    assert tuple(q.shape) == (S, H, W, Dh), (tuple(q.shape),
                                             tuple(k.shape))
    assert tuple(lengths.shape) == (S, W), (tuple(lengths.shape),
                                            tuple(q.shape))
    if sm_scale is None:
        sm_scale = _default_scale(Dh)
    _check_impl("decode_attention_multi", impl)
    if impl == "dense":
        return decode_attention_multi_reference(q, k, v, lengths,
                                                sm_scale=sm_scale)
    if q.is_cuda:
        return decode_multi_cuda(q.contiguous(), k.contiguous(),
                                 v.contiguous(), _i32(lengths), sm_scale)
    return decode_multi_plain(q, k, v, lengths, sm_scale)


def decode_attention_paged_multi(q: torch.Tensor, k_pages: torch.Tensor,
                                 v_pages: torch.Tensor,
                                 page_table: torch.Tensor,
                                 lengths: torch.Tensor,
                                 sm_scale: Optional[float] = None,
                                 impl: str = "pallas",
                                 k_scale: Optional[torch.Tensor] = None,
                                 v_scale: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """Multi-query attention over the paged KV pool
    (``deepspeed_tpu/ops/pallas/decode_attention.py:776-826``): the
    per-query ``lengths [S, W]`` contract of
    :func:`decode_attention_multi` over the pool/table layout of
    :func:`decode_attention_paged`, its int8 arm included."""
    assert q.ndim == 4 and k_pages.ndim == 4, (tuple(q.shape),
                                               tuple(k_pages.shape))
    P, H, page_len, Dh = k_pages.shape
    S = page_table.shape[0]
    W = q.shape[2]
    assert tuple(q.shape) == (S, H, W, Dh), (tuple(q.shape),
                                             tuple(k_pages.shape))
    assert tuple(lengths.shape) == (S, W), (tuple(lengths.shape),
                                            tuple(q.shape))
    _check_quant_args(k_pages, k_scale, v_scale,
                      "decode_attention_paged_multi")
    if sm_scale is None:
        sm_scale = _default_scale(Dh)
    _check_impl("decode_attention_paged_multi", impl)
    if k_scale is not None:
        if impl == "dense":
            return decode_attention_multi_reference(
                q, dequantize_paged(k_pages, k_scale, page_table),
                dequantize_paged(v_pages, v_scale, page_table), lengths,
                sm_scale=sm_scale)
        if q.is_cuda:
            return decode_paged_multi_int8_cuda(
                q.contiguous(), k_pages.contiguous(), v_pages.contiguous(),
                k_scale.float().contiguous(), v_scale.float().contiguous(),
                _i32(page_table), _i32(lengths), sm_scale)
        return decode_paged_multi_int8_plain(q, k_pages, v_pages, k_scale,
                                             v_scale, page_table, lengths,
                                             sm_scale)
    if impl == "dense":
        return decode_attention_multi_reference(
            q, paged_gather(k_pages, page_table),
            paged_gather(v_pages, page_table), lengths, sm_scale=sm_scale)
    if q.is_cuda:
        return decode_paged_multi_cuda(q.contiguous(), k_pages.contiguous(),
                                       v_pages.contiguous(),
                                       _i32(page_table), _i32(lengths),
                                       sm_scale)
    return decode_paged_multi_plain(q, k_pages, v_pages, page_table,
                                    lengths, sm_scale)


#: kernel launches since the count was last set to 0 (one per call that
#: reached the CUDA kernel; the plain versions never count); the paged
#: arms count their int8 pool launches apart
decode_attention.launches = 0
decode_attention_paged.launches = 0
decode_attention_paged.launches_int8 = 0
decode_attention_multi.launches = 0
decode_attention_paged_multi.launches = 0
decode_attention_paged_multi.launches_int8 = 0
