"""Standalone block-sparse ``MatMul`` (sdd / dsd / dds) and ``Softmax`` —
the port of ``deepspeed_tpu/ops/sparse_attention/matmul.py``.

The reference exposes its block-sparse kernels as reusable ops —
``MatMul(layout, block, mode)`` and ``Softmax(layout, block)`` — which its
attention composes as sdd → softmax → dsd.  The attention here runs the
fused kernels (``ops/kernels/block_sparse.py``); these classes are the
general-purpose surface for users composing their own sparse programs,
and, as in the JAX package, they are torch ops, not a kernel.

The sparse operand is block-COO: the active blocks' values ``[..., nnz,
block, block]`` in the row-major order of a numpy index built from the
layout.  Every mode is a gather (``index_select`` on the block axis) and
one batched product (``einsum``), plus an ``index_add`` on the nnz axis
where a sparse operand's blocks accumulate into a dense output.  Those
sums over blocks (and the softmax's row sums) accumulate in fp32 for a
bf16 or fp16 operand, as the products themselves do; the JAX ops add in
the operand's type.  Autograd
differentiates all of it, so dsd and dds are each other's gradients.

The layout is a 2-D ``[nb_rows, nb_cols]`` 0/1 array: the standalone ops
are per matrix (a 3-D layout must be the same for every head; pass
``layout[0]``, or build one instance per head).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["MatMul", "Softmax"]


def _as_layout2d(layout) -> np.ndarray:
    lay = np.asarray(layout)
    if lay.ndim == 3:
        if lay.shape[0] != 1 and not (lay == lay[:1]).all():
            raise ValueError(
                "standalone sparse ops take a single 2-D layout; this "
                "3-D layout differs across heads — vmap per-head "
                "instances instead")
        lay = lay[0]
    if lay.ndim != 2:
        raise ValueError(f"layout must be 2-D [nb, nb], got {lay.shape}")
    return lay != 0


class _BlockIndex:
    """The row-major block-COO index of a 0/1 layout (numpy), with its
    row and column ids as index tensors per device."""

    def __init__(self, layout):
        self.mask = _as_layout2d(layout)
        self.nb_r, self.nb_c = self.mask.shape
        r, c = np.nonzero(self.mask)
        order = np.lexsort((c, r))          # row-major
        self.rows = r[order].astype(np.int64)
        self.cols = c[order].astype(np.int64)
        self.nnz = len(self.rows)
        if self.nnz == 0:
            raise ValueError("layout has no active blocks")
        self._on: Dict[torch.device, tuple] = {}

    def on(self, device) -> tuple:
        """(rows, cols) as int64 tensors on ``device``."""
        device = torch.device(device)
        if device not in self._on:
            self._on[device] = (torch.from_numpy(self.rows).to(device),
                                torch.from_numpy(self.cols).to(device))
        return self._on[device]


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type a sum over blocks accumulates in: fp32 for a 16-bit
    operand (a row of a 4096-token layout adds ~70 blocks, each add
    rounded in bf16 would cost it ~2 % of its largest value), else the
    operand's own."""
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) \
        else dtype


def _scatter_add(part, index, n: int):
    """``part [..., nnz, r, c]`` summed into ``[..., n, r, c]`` by
    ``index`` on the nnz axis (accumulated in :func:`_acc_dtype`)."""
    acc = _acc_dtype(part.dtype)
    out = part.new_zeros((*part.shape[:-3], n, *part.shape[-2:]), dtype=acc)
    return out.index_add(part.dim() - 3, index, part.to(acc)).to(part.dtype)


class MatMul:
    """Block-sparse matmul in one of the reference's three modes.

    mode 'sdd':  C_sparse = A_dense @ B_dense   (only active blocks)
        a: [..., M, K], b: [..., K, N] -> [..., nnz, block, block]
    mode 'dsd':  C_dense  = A_sparse @ B_dense
        a: [..., nnz, block, block], b: [..., K, N] -> [..., M, N]
    mode 'dds':  C_dense  = A_dense @ B_sparse
        a: [..., M, K], b: [..., nnz, block, block] -> [..., M, N]

    ``trans_a`` / ``trans_b`` transpose the *dense* operand(s) before the
    product (the reference flag surface); a transposed sparse operand is
    expressed by transposing the layout and swapping to the dual mode.
    """

    def __init__(self, layout, block: int, mode: str,
                 trans_a: bool = False, trans_b: bool = False):
        if mode not in ("sdd", "dsd", "dds"):
            raise ValueError(f"mode must be sdd|dsd|dds, got {mode!r}")
        if mode != "sdd" and (trans_a if mode == "dsd" else trans_b):
            raise ValueError(
                "transposing the sparse operand: transpose the layout "
                "and use the dual mode instead")
        self.index = _BlockIndex(layout)
        self.block = int(block)
        self.mode = mode
        self.trans_a = trans_a
        self.trans_b = trans_b

    @property
    def layout(self) -> np.ndarray:
        return self.index.mask

    def _blockify(self, x, nb: int, what: str):
        """[..., nb*block, D] -> [..., nb, block, D]"""
        if x.shape[-2] != nb * self.block:
            raise ValueError(
                f"{what} dim {x.shape[-2]} != {nb} blocks x {self.block}")
        return x.reshape(*x.shape[:-2], nb, self.block, x.shape[-1])

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        idx, blk = self.index, self.block
        if self.mode == "sdd":
            rows, cols = idx.on(a.device)
            if self.trans_a:
                a = a.transpose(-1, -2)
            if self.trans_b:
                b = b.transpose(-1, -2)
            ab = self._blockify(a, idx.nb_r, "a rows")      # [..., nbr, blk, K]
            bb = self._blockify(b.transpose(-1, -2), idx.nb_c,
                                "b cols")                   # [..., nbc, blk, K]
            ga = ab.index_select(ab.dim() - 3, rows)        # [..., nnz, blk, K]
            gb = bb.index_select(bb.dim() - 3, cols)        # [..., nnz, blk, K]
            return torch.einsum("...zik,...zjk->...zij", ga, gb)
        if self.mode == "dsd":
            rows, cols = idx.on(b.device)
            if self.trans_b:
                b = b.transpose(-1, -2)
            bb = self._blockify(b, idx.nb_c, "b rows")      # [..., nbc, blk, N]
            gb = bb.index_select(bb.dim() - 3, cols)        # [..., nnz, blk, N]
            part = torch.einsum("...zij,...zjn->...zin", a, gb)
            out = _scatter_add(part, rows, idx.nb_r)        # [..., nbr, blk, N]
            return out.reshape(*out.shape[:-3], idx.nb_r * blk,
                               out.shape[-1])
        # dds
        rows, cols = idx.on(a.device)
        if self.trans_a:
            a = a.transpose(-1, -2)
        ab = self._blockify(a.transpose(-1, -2), idx.nb_r,
                            "a cols")                       # [..., nbr, blk, M]
        ga = ab.index_select(ab.dim() - 3, rows)            # [..., nnz, blk, M]
        part = torch.einsum("...zkm,...zkj->...zmj", ga, b)  # [..., nnz, M, blk]
        out = _scatter_add(part, cols, idx.nb_c)            # [..., nbc, M, blk]
        out = out.transpose(-3, -2)                         # [..., M, nbc, blk]
        return out.reshape(*out.shape[:-2], idx.nb_c * blk)


class Softmax:
    """Row softmax over a block-sparse matrix in block-COO values form.

    x: [..., nnz, block, block] (the sdd output) -> same shape, where each
    scores row (a row inside a row-block, spanning that row-block's active
    column blocks) is softmaxed over the ACTIVE columns only — inactive
    blocks are exactly zero, as in the reference's sparse softmax and the
    fused kernels (fully masked rows → zeros, not NaN).

    ``scale`` multiplies the scores first; ``key_padding_mask`` /
    ``attn_mask`` are additive float masks (``[N]`` or ``[B, N]``, a
    batched one aligned to the leading axis / ``[M, N]``) applied before
    the normalization.
    """

    def __init__(self, layout, block: int):
        self.index = _BlockIndex(layout)
        self.block = int(block)

    def __call__(self, x: torch.Tensor, scale: float = 1.0,
                 key_padding_mask: torch.Tensor = None,
                 attn_mask: torch.Tensor = None) -> torch.Tensor:
        idx, blk = self.index, self.block
        rows, cols = idx.on(x.device)
        x = x * scale
        if attn_mask is not None:
            mb = attn_mask.reshape(idx.nb_r, blk, idx.nb_c, blk)
            mb = mb.transpose(1, 2)                     # [nbr, nbc, blk, blk]
            x = x + mb[rows, cols]
        if key_padding_mask is not None:
            kpm = key_padding_mask
            if kpm.dim() not in (1, 2):
                raise ValueError(
                    "key_padding_mask must be [N] or [batch, N]")
            kb = kpm.reshape(*kpm.shape[:-1], idx.nb_c, blk)
            kb = kb.index_select(kb.dim() - 2, cols)    # [(B,) nnz, blk]
            # the mask hits the COLUMN axis of x [..., nnz, blk, blk] and
            # is constant over rows; a batched mask's B lines up with x's
            # LEADING axis (the axes between, such as heads, broadcast)
            if kpm.dim() == 1:
                kb = kb[:, None, :]                      # [nnz, 1, blk]
            else:
                extra = (x.dim() - 3) - (kpm.dim() - 1)
                if extra < 0:
                    raise ValueError(
                        f"batched key_padding_mask {tuple(kpm.shape)} does "
                        f"not fit values of shape {tuple(x.shape)}")
                kb = kb.reshape(kb.shape[0], *([1] * extra), kb.shape[-2],
                                1, kb.shape[-1])
            x = x + kb
        # the row max over a row-block's active blocks (a scatter amax on
        # the nnz axis, held out of the gradient: the softmax does not
        # depend on the shift), then the row sums the same way
        nd = x.dim() - 3                                 # the nnz axis of mx
        mx = x.detach().amax(dim=-1)                     # [..., nnz, blk]
        fill = torch.tensor(-1e30, dtype=x.dtype).item()  # -inf in fp16
        row_max = mx.new_full((*mx.shape[:-2], idx.nb_r, blk), fill)
        row_max = row_max.scatter_reduce(
            nd, rows.view(-1, 1).expand(mx.shape[nd:]).expand_as(mx), mx,
            "amax")
        # a row whose active columns are all masked to -inf never raises
        # its max above the fill, and in fp16 the fill is -inf itself:
        # such a dead row takes a zero shift, its exps underflow to 0, and
        # the denominator guard below emits zeros
        safe_max = torch.where(row_max <= fill, torch.zeros_like(row_max),
                               row_max)
        p = torch.exp(x - safe_max.index_select(nd, rows)[..., None])
        acc = _acc_dtype(x.dtype)
        row_sum = torch.zeros(row_max.shape, dtype=acc,
                              device=x.device).index_add(
            nd, rows, p.sum(dim=-1, dtype=acc))
        denom = row_sum.index_select(nd, rows)[..., None]
        return (p / torch.where(denom == 0.0, torch.ones_like(denom),
                                denom)).to(x.dtype)
