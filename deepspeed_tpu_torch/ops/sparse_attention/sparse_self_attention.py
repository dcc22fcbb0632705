"""Block-sparse self-attention — the port of
``deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py``.

Two paths, chosen per call as the JAX package chooses them:

- the block-sparse kernels (``ops/kernels/block_sparse_attention.py``:
  forward, dQ and dK/dV) when there is no ``rpe``, no
  ``key_padding_mask``, no ``attn_mask`` and T is a multiple of the block;
- otherwise the gathered-block path ``_sparse_attn`` in torch ops: every
  query block row gathers its active key/value blocks (a LUT padded to the
  row-max count) and runs a dense softmax over just those, with the
  relative position embedding, both masks in their ``add`` and ``mul``
  modes, and the fully-masked-row guard (such rows output zeros).

Semantics (the reference's forward, softmax.py there):
  scores = (Q·Kᵀ) * scale over the active blocks; scores += rpe;
  key_padding_mask / attn_mask: 'add' → scores += mask, 'mul' → -inf
  where mask == 0; softmax over each row's active blocks; context =
  probs · V.

The lookup tables are built on the host once per sequence length and kept
on the device once per (sequence length, device), so a forward copies
nothing from the host.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels.block_sparse_attention import (BLOCKS, GroupLuts,
                                              block_sparse_attention,
                                              build_group_luts,
                                              build_kernel_luts, device_luts)
from .sparsity_config import FixedSparsityConfig, SparsityConfig

_NEG_INF = float(np.finfo(np.float32).min)


def build_lut(layout: np.ndarray, use_native: Optional[bool] = None
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Layout [H, nb, nb] → (cols [H, nb, width] int32, valid [H, nb,
    width] bool): each query block row's active key blocks, padded with 0,
    and the flags of the real entries; ``width`` is the largest active
    count.  The native arm is the host C++ pass in
    ``csrc/sparse_lut.cpp`` (built by ``ops/op_builder.py``, the library
    CPU-Adam loads): ``use_native=True`` builds it or raises
    ``OpBuilderError``; ``None`` uses it only when something already
    loaded it (sparse attention alone never pays a g++ compile);
    ``False`` builds with numpy.  Both arms give the same tables."""
    if use_native or use_native is None:
        import ctypes
        from ..op_builder import cpu_ops_loaded, load_cpu_ops
        lib = load_cpu_ops() if use_native else cpu_ops_loaded()
        if lib is not None:
            H, nb, _ = layout.shape
            lay = np.ascontiguousarray(layout, dtype=np.int32)
            i32p = ctypes.POINTER(ctypes.c_int32)
            width = int(lib.ds_lut_width(H, nb, lay.ctypes.data_as(i32p)))
            cols = np.zeros((H, nb, width), dtype=np.int32)
            valid = np.zeros((H, nb, width), dtype=np.uint8)
            lib.ds_build_lut(H, nb, lay.ctypes.data_as(i32p), width,
                             cols.ctypes.data_as(i32p),
                             valid.ctypes.data_as(
                                 ctypes.POINTER(ctypes.c_uint8)))
            return cols, valid.astype(bool)
    H, nb, _ = layout.shape
    width = max(int(layout.sum(-1).max()), 1)
    cols = np.zeros((H, nb, width), dtype=np.int32)
    valid = np.zeros((H, nb, width), dtype=bool)
    for h in range(H):
        for r in range(nb):
            (active,) = np.nonzero(layout[h, r])
            cols[h, r, :len(active)] = active
            valid[h, r, :len(active)] = True
    return cols, valid


def _gather_mask(mask, cols, block: int):
    """A [T, T] mask (rpe or attn_mask) cut into [nb, blk, nb, blk] blocks
    and gathered along each query block row's LUT: [H, nb, blk, W, blk]."""
    nb = mask.shape[0] // block
    mb = mask.reshape(nb, block, nb, block)
    rows = torch.arange(nb, device=mask.device)[None, :, None]
    return mb[rows, :, cols, :].permute(0, 1, 3, 2, 4)


def _sparse_attn(q, k, v, cols, valid, rpe, key_padding_mask, attn_mask,
                 scale: float, block: int, kp_mode: str, am_mode: str):
    """The gathered-block path: q, k, v [B, H, T, D]; cols/valid [H, nb,
    W] on q's device; returns [B, H, T, D] in q.dtype.  Scores and the
    softmax run in fp32, the probabilities are cast to q.dtype before the
    value product, as in the JAX package."""
    B, H, T, D = q.shape
    nb = T // block
    W = cols.shape[-1]
    heads = torch.arange(H, device=q.device)[:, None, None]
    qb = q.reshape(B, H, nb, block, D)
    kg = k.reshape(B, H, nb, block, D)[:, heads, cols]  # [B,H,nb,W,blk,D]
    vg = v.reshape(B, H, nb, block, D)[:, heads, cols]
    scores = torch.einsum("bhrqd,bhrwkd->bhrqwk", qb.float(),
                          kg.float()) * scale
    if rpe is not None:
        scores = scores + _gather_mask(rpe, cols, block)[None].float()
    if attn_mask is not None:
        am = _gather_mask(attn_mask, cols, block)[None]
        scores = (scores + am.float() if am_mode == "add"
                  else torch.where(am != 0, scores, _NEG_INF))
    if key_padding_mask is not None:
        # [B, T] → gathered [B, H, nb, W, blk] → [B, H, nb, 1, W, blk]
        kp = key_padding_mask.reshape(B, nb, block)[:, cols][:, :, :, None]
        scores = (scores + kp.float() if kp_mode == "add"
                  else torch.where(kp != 0, scores, _NEG_INF))
    # the LUT's padding entries
    scores = torch.where(valid[None, :, :, None, :, None], scores, _NEG_INF)
    flat = scores.reshape(B, H, nb, block, W * block)
    # fully-masked rows (all -inf) give zeros, not NaN
    m = flat.amax(dim=-1, keepdim=True)
    e = torch.exp(flat - m.detach())
    e = torch.where(flat <= _NEG_INF / 2, 0.0, e)
    s = e.sum(dim=-1, keepdim=True)
    probs = torch.where(s > 0, e / s.clamp_min(1e-30), 0.0)
    probs = probs.reshape(B, H, nb, block, W, block).to(q.dtype)
    out = torch.einsum("bhrqwk,bhrwkd->bhrqd", probs, vg)
    return out.reshape(B, H, T, D)


class SparseSelfAttention:
    """The reference module's surface: ``forward(q, k, v, rpe=None,
    key_padding_mask=None, attn_mask=None)`` over [B, H, T, Dh] tensors
    (``__call__`` is the same).  LUTs are cached per sequence length, and
    their device copies per (sequence length, device)."""

    def __init__(self, sparsity_config: Optional[SparsityConfig] = None,
                 key_padding_mask_mode: str = "add",
                 attn_mask_mode: str = "mul",
                 max_seq_length: int = 2048):
        self.sparsity_config = sparsity_config or FixedSparsityConfig(
            num_heads=4)
        if key_padding_mask_mode not in ("add", "mul"):
            raise ValueError("key_padding_mask_mode must be 'add' or 'mul'")
        if attn_mask_mode not in ("add", "mul"):
            raise ValueError("attn_mask_mode must be 'add' or 'mul'")
        self.key_padding_mask_mode = key_padding_mask_mode
        self.attn_mask_mode = attn_mask_mode
        self.max_seq_length = max_seq_length
        self._lut_cache = {}
        self._layout_cache = {}
        self._device_cache = {}

    def _layout(self, seq_len: int) -> np.ndarray:
        if seq_len not in self._layout_cache:
            self._layout_cache[seq_len] = np.asarray(
                self.sparsity_config.make_layout(seq_len))
        return self._layout_cache[seq_len]

    def get_lut(self, seq_len: int) -> Tuple[np.ndarray, np.ndarray]:
        """The gather path's (cols, valid) of ``seq_len``, numpy."""
        if seq_len not in self._lut_cache:
            self._lut_cache[seq_len] = build_lut(self._layout(seq_len))
        return self._lut_cache[seq_len]

    def _on_device(self, kind: str, seq_len: int, device):
        """The ``kind`` ('kernel' or 'gather') tables of ``seq_len`` on
        ``device``, uploaded on first use: for the kernels the four LUT
        arrays and their group tables (``build_group_luts``)."""
        key = (kind, seq_len, str(device))
        if key not in self._device_cache:
            if kind == "kernel":
                block = self.sparsity_config.block
                host = build_kernel_luts(self._layout(seq_len))
                groups = (GroupLuts(*device_luts(build_group_luts(
                    *host, block), device)) if block in BLOCKS else None)
                luts = (device_luts(host, device), groups)
            else:
                cols, valid = self.get_lut(seq_len)
                luts = (torch.from_numpy(cols).long().to(device),
                        torch.from_numpy(valid).to(device))
            self._device_cache[key] = luts
        return self._device_cache[key]

    def __call__(self, query, key, value, rpe=None, key_padding_mask=None,
                 attn_mask=None):
        B, H, T, D = query.shape
        if query.shape != key.shape or key.shape != value.shape:
            raise NotImplementedError(
                "only self-attention is supported (q/k/v same shape)")
        if H != self.sparsity_config.num_heads:
            raise ValueError(
                f"input has {H} heads but sparsity config was built for "
                f"{self.sparsity_config.num_heads}")
        block = self.sparsity_config.block
        if rpe is None and key_padding_mask is None and attn_mask is None \
                and T % block == 0:
            luts, groups = self._on_device("kernel", T, query.device)
            return block_sparse_attention(query, key, value,
                                          self._layout(T), block, luts=luts,
                                          groups=groups)
        cols, valid = self._on_device("gather", T, query.device)
        return _sparse_attn(query, key, value, cols, valid, rpe,
                            key_padding_mask, attn_mask, float(D) ** -0.5,
                            block, self.key_padding_mask_mode,
                            self.attn_mask_mode)

    forward = __call__
