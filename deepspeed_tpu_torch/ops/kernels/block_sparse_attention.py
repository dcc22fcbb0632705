"""Block-sparse attention, forward and backward: the three hand-written
Hopper kernels, their plain PyTorch versions and the autograd Function over
them.

Port of ``deepspeed_tpu/ops/pallas/block_sparse_attention.py``:
``build_kernel_luts``, the ``_sparse`` custom_vjp (``_sparse_fwd`` /
``_sparse_bwd``), ``block_sparse_attention`` and the three kernels it
launches.  On a CUDA tensor the forward launches ``csrc/block_sparse_fwd.cu``
and the backward ``csrc/block_sparse_bwd_dq.cu`` (row LUT) and
``csrc/block_sparse_bwd_dkv.cu`` (transposed LUT); on a CPU tensor each
runs its plain PyTorch version (the CPU tests' path and the kernels'
yardstick on the card).  There is no fallback: a CUDA tensor reaches its
kernel or the call raises.

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
from typing import Optional, Tuple

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


def device_luts(luts, device) -> Tuple[torch.Tensor, ...]:
    """The four LUT arrays as int32 tensors on ``device`` (a tensor already
    there passes through uncopied)."""
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
#: bh, heads, lut_heads, t, block, width, scale, dtype, stream
_TAIL = [_INT] * 6 + [_FLOAT, _INT, _PTR]
_N_TENSORS = {"block_sparse_fwd": 7, "block_sparse_bwd_dq": 9,
              "block_sparse_bwd_dkv": 10}


def _load(name: str):
    fn = getattr(build.load(name), name)
    if fn.argtypes is None:
        fn.argtypes = [_PTR] * _N_TENSORS[name] + _TAIL
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


def _launch(name: str, tensors, q, idx, block: int, sm_scale) -> None:
    B, H, T, _ = q.shape
    fn = _load(name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(*[t.data_ptr() for t in tensors], B * H, H, idx.shape[0], T,
                block, idx.shape[2], float(sm_scale), _DTYPE_CODES[q.dtype],
                stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def block_sparse_fwd_cuda(q, k, v, cols, nvalid, sm_scale: float,
                          block: int):
    """Launch ``csrc/block_sparse_fwd.cu`` on contiguous CUDA tensors q, k,
    v [B,H,T,64] of one dtype (fp32, bf16 or fp16) with the row LUT as
    int32 tensors on the same device.  Returns ``(out [B,H,T,64] in
    q.dtype, lse [B,H,T] fp32)``; raises on anything the kernel does not
    take and on a failed launch."""
    _check("block_sparse_fwd_cuda", block, cols, nvalid, q=q, k=k, v=v)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    _launch("block_sparse_fwd", (q, k, v, out, lse, cols, nvalid), q, cols,
            block, sm_scale)
    block_sparse_fwd.launches += 1
    return out, lse


def block_sparse_bwd_dq_cuda(q, k, v, do, lse, delta, cols, nvalid,
                             sm_scale: float, block: int):
    """Launch ``csrc/block_sparse_bwd_dq.cu``: dQ [B,H,T,64] in q.dtype
    from q, k, v, dO (one dtype), fp32 lse/delta [B,H,T] and the row
    LUT."""
    _check("block_sparse_bwd_dq_cuda", block, cols, nvalid, q=q, k=k, v=v,
           do=do, lse=lse, delta=delta)
    dq = torch.empty_like(q)
    if dq.numel() == 0:
        return dq
    _launch("block_sparse_bwd_dq", (q, k, v, do, lse, delta, dq, cols,
                                    nvalid), q, cols, block, sm_scale)
    block_sparse_bwd_dq.launches += 1
    return dq


def block_sparse_bwd_dkv_cuda(q, k, v, do, lse, delta, rows_t, nvalid_t,
                              sm_scale: float, block: int):
    """Launch ``csrc/block_sparse_bwd_dkv.cu``: ``(dk, dv)`` [B,H,T,64] in
    the input dtype, over the transposed LUT."""
    _check("block_sparse_bwd_dkv_cuda", block, rows_t, nvalid_t, q=q, k=k,
           v=v, do=do, lse=lse, delta=delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0:
        return dk, dv
    _launch("block_sparse_bwd_dkv", (q, k, v, do, lse, delta, dk, dv, rows_t,
                                     nvalid_t), q, rows_t, block, sm_scale)
    block_sparse_bwd_dkv.launches += 1
    return dk, dv


def block_sparse_fwd(q, *args, **kwargs):
    """(O, lse): the kernel on a CUDA tensor, its plain version on a CPU
    one."""
    fn = block_sparse_fwd_cuda if q.is_cuda else block_sparse_fwd_plain
    return fn(q, *args, **kwargs)


def block_sparse_bwd_dq(q, *args, **kwargs):
    """dQ: the kernel on a CUDA tensor, its plain version on a CPU one."""
    fn = block_sparse_bwd_dq_cuda if q.is_cuda else block_sparse_bwd_dq_plain
    return fn(q, *args, **kwargs)


def block_sparse_bwd_dkv(q, *args, **kwargs):
    """(dK, dV): the kernel on a CUDA tensor, its plain version on a CPU
    one."""
    fn = (block_sparse_bwd_dkv_cuda if q.is_cuda
          else block_sparse_bwd_dkv_plain)
    return fn(q, *args, **kwargs)


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
    and runs the dQ (row LUT) and dK/dV (transposed LUT) kernels."""

    @staticmethod
    def forward(ctx, q, k, v, cols, nvalid, rows_t, nvalid_t, sm_scale,
                block):
        out, lse = block_sparse_fwd(q, k, v, cols, nvalid, sm_scale, block)
        ctx.save_for_backward(q, k, v, out, lse, cols, nvalid, rows_t,
                              nvalid_t)
        ctx.args = (sm_scale, block)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, cols, nvalid, rows_t, nvalid_t = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * out.float()).sum(-1)
        dq = block_sparse_bwd_dq(q, k, v, do, lse, delta, cols, nvalid,
                                 *ctx.args)
        dk, dv = block_sparse_bwd_dkv(q, k, v, do, lse, delta, rows_t,
                                      nvalid_t, *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None


def block_sparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           layout, block: int,
                           sm_scale: Optional[float] = None,
                           luts=None) -> torch.Tensor:
    """Block-sparse attention over [B, H, T, Dh] with a [H, nb, nb] 0/1
    layout (differentiable) — the JAX package's ``block_sparse_attention``
    minus its ``interpret`` argument.  T must be a multiple of ``block``
    (``SparseAttentionUtils.pad_to_block_size`` pads).  ``luts``: prebuilt
    ``build_kernel_luts(layout)`` output, numpy or — for a caller in a hot
    loop, as ``SparseSelfAttention`` is — already on q's device
    (``device_luts``), so the call copies nothing from the host."""
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
    return _BlockSparse.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                              *device_luts(luts, q.device), float(sm_scale),
                              int(block))
