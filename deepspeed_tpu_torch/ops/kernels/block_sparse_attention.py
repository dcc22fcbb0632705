"""Block-sparse attention, forward and backward: the three hand-written
Hopper kernels, their plain PyTorch versions and the autograd Function over
them.

Port of ``deepspeed_tpu/ops/pallas/block_sparse_attention.py``:
``build_kernel_luts``, the ``_sparse`` custom_vjp (``_sparse_fwd`` /
``_sparse_bwd``), ``block_sparse_attention`` and the three kernels it
launches.  On a CUDA tensor the forward launches ``csrc/block_sparse_fwd.cu``
and the backward ``csrc/block_sparse_bwd_dq.cu`` and
``csrc/block_sparse_bwd_dkv.cu``; on a CPU tensor each
runs its plain PyTorch version (the CPU tests' path and the kernels'
yardstick on the card).  There is no fallback: a CUDA tensor reaches its
kernel or the call raises.

In bf16 and fp16 the three kernels run on the tensor cores
(``csrc/block_sparse_mma.cuh``) and walk grouped tables instead of the LUT
rows: ``build_group_luts`` gathers the query block rows (key blocks) one
CUDA block owns into a group, with the union of their LUT rows and a
member mask per entry; the forward and dQ walk the query-row groups,
dK/dV the key-block groups.  It runs once per layout on the host, beside
``build_kernel_luts``; the CUDA wrappers take its tables on the device
(``groups``) and raise without them (the fp32 arms walk the LUT rows and
do not read them).

Sparsity is block-granular, as in the JAX kernels: an active block attends
fully, a query row with no active block outputs zeros (lse -1e30) with zero
gradients.  Masks and relative position embeddings take the gather path of
``ops/sparse_attention/sparse_self_attention.py`` instead.

The lookup tables live in device memory, so the TPU kernels' SMEM budget
(the ``smem_need > 900_000`` guard of the JAX ``block_sparse_attention``)
does not apply here and is not carried over: any layout that fits the
card's memory runs.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import build
from .flash_attention import _DTYPE_CODES, HEAD_DIM

NEG_INF = -1e30
#: the sparsity block sizes the kernels are built for (the reference's
#: Triton set); the plain versions take any block
BLOCKS = (16, 32, 64, 128)
#: CUDA's limit on the grid's second dimension, which runs over B·H
_MAX_BH = 65535


def build_kernel_luts(layout: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray,
                                 np.ndarray, np.ndarray]:
    """Layout [H, nb, nb] → (cols, nvalid, rows_t, nvalid_t), int32 numpy —
    the JAX package's arrays, entry for entry.

    ``cols[h, r]`` lists query block row r's active key blocks, padded by
    repeating the last valid entry; ``nvalid[h, r]`` is the true count.
    ``rows_t``/``nvalid_t`` are the transposed LUT (per key block, the
    query block rows attending to it) for the dK/dV pass.  A row or column
    with no active block gets one self-referential padding entry and count
    0.  Identical head planes collapse to one (``lut_heads = 1``); the
    kernels read plane ``h % lut_heads``.  The kernels walk only the first
    ``nvalid`` entries, so the padding is never read on the card."""
    if layout.shape[0] > 1 and bool((layout == layout[:1]).all()):
        layout = layout[:1]
    H, nb, _ = layout.shape
    W = max(int(layout.sum(-1).max()), 1)
    Wt = max(int(layout.sum(-2).max()), 1)
    cols = np.zeros((H, nb, W), np.int32)
    nvalid = np.zeros((H, nb), np.int32)
    rows_t = np.zeros((H, nb, Wt), np.int32)
    nvalid_t = np.zeros((H, nb), np.int32)
    for h in range(H):
        for idx, count, plane in ((cols, nvalid, layout[h]),
                                  (rows_t, nvalid_t, layout[h].T)):
            for r in range(nb):
                (active,) = np.nonzero(plane[r])
                count[h, r] = len(active)
                if len(active):
                    idx[h, r, :len(active)] = active
                    idx[h, r, len(active):] = active[-1]
                else:
                    idx[h, r, :] = r
    return cols, nvalid, rows_t, nvalid_t


def group_size(block: int) -> int:
    """Sparsity blocks (query block rows, or key blocks) one CUDA block of
    the tensor-core kernels owns: four warps of 16 rows
    cover 64 rows, so 4, 2 and 1 at blocks 16, 32 and 64; at block 128 a
    group is one block, owned by two CUDA blocks (one half each)."""
    return 64 // min(block, 64)


class GroupLuts(NamedTuple):
    """The grouped lookup tables the tensor-core kernels walk, one plane
    per LUT plane (int32, numpy or on the device).

    A group is ``group_size(block)`` sparsity blocks owned by one CUDA
    block: consecutive query block rows for the forward and dQ, key blocks in
    the order of ``dkv_keys`` for dK/dV.  Its union lists every block any
    member uses, ascending, with a member mask per entry (bit j: member j
    uses it), so member j's masked entries are exactly its own ``cols``
    (``rows_t``) row, in order.  The CUDA block streams each union entry
    once for all its members; a warp skips the entries its bit is clear
    on."""
    fwd_idx: object    # [P, ng, U] union key blocks of query rows gG..gG+G-1
    fwd_mask: object   # [P, ng, U] member bits
    fwd_count: object  # [P, ng] union sizes
    dkv_keys: object   # [P, ngt, G] member key blocks, -1 where none
    dkv_idx: object    # [P, ngt, Ut] union query blocks
    dkv_mask: object   # [P, ngt, Ut] member bits
    dkv_count: object  # [P, ngt] union sizes


def _active(idx: np.ndarray, count: np.ndarray) -> np.ndarray:
    """A LUT [P, nb, W] with its counts → the active blocks [P, nb, nb]
    as booleans."""
    P, nb, W = idx.shape
    p, r, w = np.nonzero(np.arange(W) < count[..., None])
    act = np.zeros((P, nb, nb), bool)
    act[p, r, idx[p, r, w]] = True
    return act


def _unions(act: np.ndarray, members: np.ndarray):
    """Per group: the union of its members' active blocks (ascending),
    each entry's member bits, and the union's size.  ``act`` [P, nb, nb],
    ``members`` [P, ng, G] (-1 where a group has no such member)."""
    P, ng, G = members.shape
    rows = act[np.arange(P)[:, None, None], np.maximum(members, 0)]
    rows &= (members >= 0)[..., None]                  # [P, ng, G, nb]
    bits = (rows.astype(np.int32) << np.arange(G, dtype=np.int32)[
        :, None]).sum(2)                               # [P, ng, nb]
    count = (bits > 0).sum(-1).astype(np.int32)
    idx = np.zeros((P, ng, max(int(count.max()), 1)), np.int32)
    mask = np.zeros_like(idx)
    for p in range(P):
        for g in range(ng):
            (u,) = np.nonzero(bits[p, g])
            idx[p, g, :len(u)] = u
            mask[p, g, :len(u)] = bits[p, g, u]
    return idx, mask, count


def build_group_luts(cols, nvalid, rows_t, nvalid_t, block: int
                     ) -> GroupLuts:
    """The grouped tables of ``build_kernel_luts``'s four arrays (numpy),
    built once per layout on the host.

    Forward: group g holds query block rows gG..gG+G-1 (G =
    ``group_size(block)``).  dK/dV: key blocks ordered by ``nvalid_t``
    descending, ties broken by their ``rows_t`` rows so identical columns
    fall together, then packed G to a group: the heaviest groups come
    first (the kernel launches them first) and columns that share their
    query blocks share their loads."""
    if block not in BLOCKS:
        raise ValueError(f"build_group_luts: block {block}; the kernels "
                         f"take block in {BLOCKS}")
    G = group_size(block)
    P, nb = nvalid.shape
    ng = -(-nb // G)
    slots = np.arange(ng * G)
    fwd_members = np.broadcast_to(np.where(slots < nb, slots, -1).reshape(
        ng, G), (P, ng, G))
    dkv_members = np.full((P, ng * G), -1, np.int64)
    for p in range(P):
        keys = tuple(rows_t[p].T[::-1]) + (-nvalid_t[p],)
        dkv_members[p, :nb] = np.lexsort(keys)
    dkv_members = dkv_members.reshape(P, ng, G)
    fwd = _unions(_active(cols, nvalid), fwd_members)
    dkv = _unions(_active(rows_t, nvalid_t), dkv_members)
    return GroupLuts(*fwd, dkv_members.astype(np.int32), *dkv)


def device_luts(luts, device) -> Tuple[torch.Tensor, ...]:
    """The LUT arrays (``build_kernel_luts``' four, or the seven of a
    ``GroupLuts``) as int32 tensors on ``device`` (a tensor already there
    passes through uncopied)."""
    out = []
    for a in luts:
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(a, dtype=np.int32))
        out.append(t.to(device=device, dtype=torch.int32).contiguous())
    return tuple(out)


# ---------------------------------------------------------------------------
# plain versions: the kernels' functions from the LUT, gather + einsum, fp32
# ---------------------------------------------------------------------------


def _per_head(idx, count, H):
    """A LUT ([lut_heads, nb, W]) and its counts as per-head views: the
    indices (int64) [H, nb, W] and a validity mask [H, nb, W]."""
    plane = torch.arange(H, device=idx.device) % idx.shape[0]
    idx, count = idx.long()[plane], count.long()[plane]
    width = torch.arange(idx.shape[-1], device=idx.device)
    return idx, width < count[..., None]


def _gather(x, idx):
    """x [B, H, nb, blk, ...] gathered along nb by idx [H, nb, W] →
    [B, H, nb, W, blk, ...]."""
    heads = torch.arange(x.shape[1], device=x.device)[:, None, None]
    return x[:, heads, idx]


def _blocks(x, block):
    B, H, T = x.shape[:3]
    return x.float().reshape(B, H, T // block, block, *x.shape[3:])


def block_sparse_fwd_plain(q, k, v, cols, nvalid, sm_scale: float,
                           block: int):
    """The forward kernel's function in plain PyTorch: ``(out [B,H,T,Dh]
    in q.dtype, lse [B,H,T] fp32)``, each query block row attending to the
    key blocks its LUT row lists; rows with no active block give 0 and
    lse -1e30."""
    B, H, T, D = q.shape
    idx, valid = _per_head(cols, nvalid, H)
    vmask = valid[None, :, :, None, :, None]
    kg, vg = _gather(_blocks(k, block), idx), _gather(_blocks(v, block), idx)
    s = torch.einsum("bhrqd,bhrwkd->bhrqwk", _blocks(q, block), kg) * sm_scale
    s = torch.where(vmask, s, NEG_INF)
    m = s.amax(dim=(-2, -1), keepdim=True)
    p = torch.where(vmask, torch.exp(s - m), 0.0)
    l = p.sum(dim=(-2, -1), keepdim=True)
    l_safe = torch.where(l == 0, 1.0, l)
    out = torch.einsum("bhrqwk,bhrwkd->bhrqd", p, vg) / l_safe[..., 0]
    lse = torch.where(l == 0, NEG_INF, m + torch.log(l_safe))
    return (out.reshape(B, H, T, D).to(q.dtype),
            lse.reshape(B, H, T))


def block_sparse_bwd_dq_plain(q, k, v, do, lse, delta, cols, nvalid,
                              sm_scale: float, block: int):
    """The dQ kernel's function in plain PyTorch over the row LUT: ``dq =
    ds · K`` with ``ds = p (dO·Vᵀ − delta) sm_scale`` and ``p`` recomputed
    from the saved ``lse`` ([B,H,T] fp32); dQ in q.dtype."""
    B, H, T, D = q.shape
    idx, valid = _per_head(cols, nvalid, H)
    vmask = valid[None, :, :, None, :, None]
    kg, vg = _gather(_blocks(k, block), idx), _gather(_blocks(v, block), idx)
    s = torch.einsum("bhrqd,bhrwkd->bhrqwk", _blocks(q, block), kg) * sm_scale
    stat = (lse.reshape(B, H, T // block, block)[..., None, None],
            delta.reshape(B, H, T // block, block)[..., None, None])
    # a row with no active block (lse -1e30) is masked before it is used
    p = torch.where(vmask, torch.exp(s - stat[0]), 0.0)
    dp = torch.einsum("bhrqd,bhrwkd->bhrqwk", _blocks(do, block), vg)
    ds = p * (dp - stat[1]) * sm_scale
    dq = torch.einsum("bhrqwk,bhrwkd->bhrqd", ds, kg)
    return dq.reshape(B, H, T, D).to(q.dtype)


def block_sparse_bwd_dkv_plain(q, k, v, do, lse, delta, rows_t, nvalid_t,
                               sm_scale: float, block: int):
    """The dK/dV kernel's function in plain PyTorch over the transposed
    LUT: for each key block, the query blocks attending to it, ``dv = pᵀ ·
    dO`` and ``dk = dsᵀ · Q``; one batch row at a time (the gathered query
    blocks are the largest tensor); results in k.dtype / v.dtype."""
    B, H, T, D = q.shape
    idx, valid = _per_head(rows_t, nvalid_t, H)
    vmask = valid[None, :, :, :, None, None]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for b in range(B):
        one = slice(b, b + 1)
        qg = _gather(_blocks(q[one], block), idx)     # [1,H,nb,Wt,blk,D]
        dog = _gather(_blocks(do[one], block), idx)
        lg = _gather(_blocks(lse[one], block), idx)[..., None]
        eg = _gather(_blocks(delta[one], block), idx)[..., None]
        kb, vb = _blocks(k[one], block), _blocks(v[one], block)
        s = torch.einsum("bhcwqd,bhckd->bhcwqk", qg, kb) * sm_scale
        p = torch.where(vmask, torch.exp(s - lg), 0.0)
        dp = torch.einsum("bhcwqd,bhckd->bhcwqk", dog, vb)
        ds = p * (dp - eg) * sm_scale
        dv[one] = torch.einsum("bhcwqk,bhcwqd->bhckd", p, dog).reshape(
            1, H, T, D).to(v.dtype)
        dk[one] = torch.einsum("bhcwqk,bhcwqd->bhckd", ds, qg).reshape(
            1, H, T, D).to(k.dtype)
    return dk, dv


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: (tensor pointers, ints) of each launcher, then scale, dtype, stream; the
#: ints are bh, heads, lut_heads, t, block, width (and for the grouped
#: kernels the groups' count and union width)
_ARGS = {"block_sparse_fwd": (10, 8), "block_sparse_bwd_dq": (12, 8),
         "block_sparse_bwd_dkv": (14, 8)}


def _load(name: str):
    fn = getattr(build.load(name), name)
    if fn.argtypes is None:
        ptrs, ints = _ARGS[name]
        fn.argtypes = [_PTR] * ptrs + [_INT] * ints + [_FLOAT, _INT, _PTR]
        fn.restype = ctypes.c_int
    return fn


def _check(fn: str, block: int, idx, count, **tensors) -> None:
    """Device, dtype, contiguity and shapes of a kernel's operands."""
    q = tensors["q"]
    B, H, T, D = q.shape
    if block not in BLOCKS or D != HEAD_DIM:
        raise ValueError(f"{fn}: block {block}, head_dim {D}; the kernels "
                         f"take block in {BLOCKS} and head_dim {HEAD_DIM}")
    if T % block or B * H > _MAX_BH:
        raise ValueError(f"{fn}: seq len {T} is not a multiple of block "
                         f"{block}, or B*H = {B * H} exceeds {_MAX_BH}")
    for name, t in {**tensors, "lut": idx, "lut counts": count}.items():
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{fn}: {name} is on {t.device}; every operand "
                             f"must be on q's CUDA device {q.device}")
        want = (torch.int32 if name.startswith("lut")
                else torch.float32 if name in ("lse", "delta") else q.dtype)
        if t.dtype != want or want not in (*_DTYPE_CODES, torch.int32):
            raise TypeError(f"{fn}: {name} has dtype {t.dtype}; q, k, v (and "
                            f"dO) share one of {list(_DTYPE_CODES)}, lse and "
                            "delta are float32, the LUT int32")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} is not contiguous")
        shape = ((B, H, T) if name in ("lse", "delta") else
                 None if name.startswith("lut") else (B, H, T, D))
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{fn}: {name} {tuple(t.shape)} is not {shape}")
    nb = T // block
    if (idx.ndim != 3 or idx.shape[0] not in (1, H) or idx.shape[1] != nb
            or tuple(count.shape) != tuple(idx.shape[:2])):
        raise ValueError(f"{fn}: LUT {tuple(idx.shape)} / counts "
                         f"{tuple(count.shape)} do not fit [1 or H={H}, "
                         f"nb={nb}, W] / [1 or H, nb]")


def _check_groups(fn: str, groups, q, idx, block: int, part: str):
    """The ``part`` ('fwd' or 'dkv') tables of ``groups`` as the kernel
    reads them: (idx, mask, count[, keys]) int32 CUDA tensors beside q,
    one plane per LUT plane.  Raises without them: the kernel never
    builds them itself (that would read the LUT back from the device)."""
    if groups is None:
        raise ValueError(
            f"{fn}: the CUDA kernel walks the grouped tables; pass "
            "groups=GroupLuts(*device_luts(build_group_luts(*luts, block), "
            "device))")
    tabs = [getattr(groups, f"{part}_{n}") for n in ("idx", "mask", "count")]
    if part == "dkv":
        tabs.append(groups.dkv_keys)
    nb = q.shape[2] // block
    ng = -(-nb // group_size(block))
    for t in tabs:
        if (not isinstance(t, torch.Tensor) or t.device != q.device
                or t.dtype != torch.int32 or not t.is_contiguous()):
            raise ValueError(f"{fn}: the group tables must be contiguous "
                             f"int32 tensors on {q.device}")
    if (tuple(tabs[0].shape[:2]) != (idx.shape[0], ng)
            or tabs[1].shape != tabs[0].shape
            or tuple(tabs[2].shape) != (idx.shape[0], ng)
            or (part == "dkv" and tuple(tabs[3].shape) != (
                idx.shape[0], ng, group_size(block)))):
        raise ValueError(f"{fn}: group tables {[tuple(t.shape) for t in tabs]}"
                         f" do not fit {idx.shape[0]} plane(s) of {ng} "
                         f"groups at block {block}")
    return tabs


def _launch(name: str, tensors, q, idx, block: int, sm_scale,
            group_dims=()) -> None:
    B, H, T, _ = q.shape
    fn = _load(name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(*[t.data_ptr() for t in tensors], B * H, H, idx.shape[0], T,
                block, idx.shape[2], *group_dims, float(sm_scale),
                _DTYPE_CODES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def block_sparse_fwd_cuda(q, k, v, cols, nvalid, sm_scale: float,
                          block: int, groups: Optional[GroupLuts] = None):
    """Launch ``csrc/block_sparse_fwd.cu`` on contiguous CUDA tensors q, k,
    v [B,H,T,64] of one dtype (fp32, bf16 or fp16) with the row LUT and
    the group tables (``groups``, walked by the bf16/fp16 arm) as int32
    tensors on the same device.  Returns ``(out [B,H,T,64] in q.dtype,
    lse [B,H,T] fp32)``; raises on anything the kernel does not take, on
    missing group tables and on a failed launch."""
    _check("block_sparse_fwd_cuda", block, cols, nvalid, q=q, k=k, v=v)
    gidx, gmask, gcount = _check_groups("block_sparse_fwd_cuda", groups, q,
                                        cols, block, "fwd")
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    _launch("block_sparse_fwd", (q, k, v, out, lse, cols, nvalid, gidx,
                                 gmask, gcount), q, cols, block, sm_scale,
            gidx.shape[1:])
    block_sparse_fwd.launches += 1
    return out, lse


def block_sparse_bwd_dq_cuda(q, k, v, do, lse, delta, cols, nvalid,
                             sm_scale: float, block: int,
                             groups: Optional[GroupLuts] = None):
    """Launch ``csrc/block_sparse_bwd_dq.cu``: dQ [B,H,T,64] in q.dtype
    from q, k, v, dO (one dtype), fp32 lse/delta [B,H,T], the row LUT (the
    fp32 arm) and the forward's group tables of ``groups`` (the bf16/fp16
    arm)."""
    _check("block_sparse_bwd_dq_cuda", block, cols, nvalid, q=q, k=k, v=v,
           do=do, lse=lse, delta=delta)
    gidx, gmask, gcount = _check_groups("block_sparse_bwd_dq_cuda", groups,
                                        q, cols, block, "fwd")
    dq = torch.empty_like(q)
    if dq.numel() == 0:
        return dq
    _launch("block_sparse_bwd_dq", (q, k, v, do, lse, delta, dq, cols,
                                    nvalid, gidx, gmask, gcount), q, cols,
            block, sm_scale, gidx.shape[1:])
    block_sparse_bwd_dq.launches += 1
    return dq


def block_sparse_bwd_dkv_cuda(q, k, v, do, lse, delta, rows_t, nvalid_t,
                              sm_scale: float, block: int,
                              groups: Optional[GroupLuts] = None):
    """Launch ``csrc/block_sparse_bwd_dkv.cu``: ``(dk, dv)`` [B,H,T,64] in
    the input dtype, over the transposed LUT (the fp32 arm) or the dK/dV
    group tables of ``groups`` (the bf16/fp16 arm)."""
    _check("block_sparse_bwd_dkv_cuda", block, rows_t, nvalid_t, q=q, k=k,
           v=v, do=do, lse=lse, delta=delta)
    gidx, gmask, gcount, gkeys = _check_groups(
        "block_sparse_bwd_dkv_cuda", groups, q, rows_t, block, "dkv")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0:
        return dk, dv
    _launch("block_sparse_bwd_dkv", (q, k, v, do, lse, delta, dk, dv, rows_t,
                                     nvalid_t, gidx, gmask, gcount, gkeys),
            q, rows_t, block, sm_scale, gidx.shape[1:])
    block_sparse_bwd_dkv.launches += 1
    return dk, dv


def block_sparse_fwd(q, k, v, cols, nvalid, sm_scale: float, block: int,
                     groups: Optional[GroupLuts] = None):
    """(O, lse): the kernel on a CUDA tensor, its plain version (which
    needs no group tables) on a CPU one."""
    if q.is_cuda:
        return block_sparse_fwd_cuda(q, k, v, cols, nvalid, sm_scale, block,
                                     groups)
    return block_sparse_fwd_plain(q, k, v, cols, nvalid, sm_scale, block)


def block_sparse_bwd_dq(q, k, v, do, lse, delta, cols, nvalid,
                        sm_scale: float, block: int,
                        groups: Optional[GroupLuts] = None):
    """dQ: the kernel on a CUDA tensor, its plain version on a CPU one."""
    if q.is_cuda:
        return block_sparse_bwd_dq_cuda(q, k, v, do, lse, delta, cols,
                                        nvalid, sm_scale, block, groups)
    return block_sparse_bwd_dq_plain(q, k, v, do, lse, delta, cols, nvalid,
                                     sm_scale, block)


def block_sparse_bwd_dkv(q, k, v, do, lse, delta, rows_t, nvalid_t,
                         sm_scale: float, block: int,
                         groups: Optional[GroupLuts] = None):
    """(dK, dV): the kernel on a CUDA tensor, its plain version on a CPU
    one."""
    if q.is_cuda:
        return block_sparse_bwd_dkv_cuda(q, k, v, do, lse, delta, rows_t,
                                         nvalid_t, sm_scale, block, groups)
    return block_sparse_bwd_dkv_plain(q, k, v, do, lse, delta, rows_t,
                                      nvalid_t, sm_scale, block)


#: kernel launches since each count was last set to 0 (one per call that
#: reached the CUDA kernel; the plain versions never count)
block_sparse_fwd.launches = 0
block_sparse_bwd_dq.launches = 0
block_sparse_bwd_dkv.launches = 0


# ---------------------------------------------------------------------------
# autograd and the public entry point
# ---------------------------------------------------------------------------


class _BlockSparse(torch.autograd.Function):
    """The JAX package's ``_sparse`` custom_vjp: the forward saves q, k, v,
    out and lse; the backward computes ``delta = rowsum(dO·O)`` in fp32
    and runs the dQ and dK/dV kernels, all three over the group tables
    (bf16/fp16) or the LUT rows (fp32)."""

    @staticmethod
    def forward(ctx, q, k, v, cols, nvalid, rows_t, nvalid_t, sm_scale,
                block, groups):
        out, lse = block_sparse_fwd(q, k, v, cols, nvalid, sm_scale, block,
                                    groups)
        ctx.save_for_backward(q, k, v, out, lse, cols, nvalid, rows_t,
                              nvalid_t)
        ctx.args = (sm_scale, block)
        ctx.groups = groups
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, cols, nvalid, rows_t, nvalid_t = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * out.float()).sum(-1)
        dq = block_sparse_bwd_dq(q, k, v, do, lse, delta, cols, nvalid,
                                 *ctx.args, ctx.groups)
        dk, dv = block_sparse_bwd_dkv(q, k, v, do, lse, delta, rows_t,
                                      nvalid_t, *ctx.args, ctx.groups)
        return dq, dk, dv, None, None, None, None, None, None, None


def block_sparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           layout, block: int,
                           sm_scale: Optional[float] = None,
                           luts=None, groups=None) -> torch.Tensor:
    """Block-sparse attention over [B, H, T, Dh] with a [H, nb, nb] 0/1
    layout (differentiable) — the JAX package's ``block_sparse_attention``
    minus its ``interpret`` argument.  T must be a multiple of ``block``
    (``SparseAttentionUtils.pad_to_block_size`` pads).  ``luts``: prebuilt
    ``build_kernel_luts(layout)`` output, and ``groups`` its
    ``build_group_luts`` tables, numpy or — for a caller in a hot loop, as
    ``SparseSelfAttention`` is — already on q's device (``device_luts``),
    so the call copies nothing from the host.  Without ``luts`` both are
    built here from the layout; with numpy ``luts`` and no ``groups`` the
    groups are built from them; device ``luts`` need their ``groups`` on
    a CUDA tensor (a block the kernels do not take has none: its CPU
    call runs the plain versions, its CUDA call raises)."""
    B, H, T, D = q.shape
    if T % block:
        raise ValueError(f"seq len {T} not a multiple of block {block}")
    nb = T // block
    if tuple(layout.shape) != (H, nb, nb):
        raise ValueError(
            f"layout {tuple(layout.shape)} != (H={H}, nb={nb}, nb={nb})")
    if sm_scale is None:
        sm_scale = float(D) ** -0.5
    if luts is None:
        luts = build_kernel_luts(np.asarray(layout))
    if (groups is None and block in BLOCKS
            and not isinstance(luts[0], torch.Tensor)):
        groups = build_group_luts(*luts, block)
    if groups is not None:
        groups = GroupLuts(*device_luts(groups, q.device))
    return _BlockSparse.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                              *device_luts(luts, q.device), float(sm_scale),
                              int(block), groups)
