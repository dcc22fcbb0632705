"""Block-sparsity layout generators — the port's own copy of
``deepspeed_tpu/ops/sparse_attention/sparsity_config.py`` (numpy only, so
the layouts are bit-equal to the JAX package's, random blocks included).

Same config surface as the reference family (reference:
deepspeed/ops/sparse_attention/sparsity_config.py — Dense :63, Fixed :94,
Variable :243, BigBird :421, BSLongformer :544), re-expressed as vectorized
numpy over block-index grids instead of per-element loops.  A layout is an
int64 array [num_heads, num_blocks, num_blocks]; entry (h, r, c) == 1 means
query block r of head h attends to key block c.

Differences from the reference, on purpose:
  - layouts are numpy (they are *static metadata* turned into lookup tables
    on the host and uploaded once per sequence length);
  - random layouts take an explicit ``seed`` (the reference uses the global
    ``random`` module state, sparsity_config.py:330, which makes layouts
    irreproducible across ranks — a real hazard under SPMD where every host
    must trace the identical layout).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np


class SparsityConfig:
    """Base: shared fields + layout allocation (reference
    sparsity_config.py:9-61)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head
        self.num_layout_heads = num_heads if different_layout_per_head else 1

    def setup_layout(self, seq_len: int) -> np.ndarray:
        if seq_len % self.block != 0:
            raise ValueError(
                f"Sequence length {seq_len} must be divisible by block "
                f"size {self.block}")
        num_blocks = seq_len // self.block
        return np.zeros((self.num_heads, num_blocks, num_blocks),
                        dtype=np.int64)

    def check_and_propagate_first_head_layout(self,
                                              layout: np.ndarray
                                              ) -> np.ndarray:
        if not self.different_layout_per_head:
            layout[1:] = layout[0]
        return layout


class DenseSparsityConfig(SparsityConfig):
    """All blocks active — kept for comparison/debug (reference :63-94)."""

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        layout[:] = 1
        return layout



def _block_grid(num_blocks: int):
    """(row, col) index grids for vectorized masking."""
    return np.meshgrid(np.arange(num_blocks), np.arange(num_blocks),
                       indexing="ij")


def _set_random_layout(h: int, layout: np.ndarray, num_random_blocks: int,
                       seed: int) -> np.ndarray:
    """Mark ``num_random_blocks`` random key blocks per row (shared by
    Variable and BigBird configs; reference sparsity_config.py:314-332,
    452-473 duplicates this too — here it lives once)."""
    nb = layout.shape[1]
    if nb < num_random_blocks:
        raise ValueError(
            f"num_random_blocks {num_random_blocks} must be < "
            f"number of block rows {nb}")
    rng = np.random.default_rng(seed + h)
    for row in range(nb):
        cols = rng.choice(nb, size=num_random_blocks, replace=False)
        layout[h, row, cols] = 1
    return layout


def _set_sliding_window_layout(h: int, layout: np.ndarray,
                               num_sliding_window_blocks: int) -> np.ndarray:
    """Banded local window of width ``num_sliding_window_blocks`` (shared
    by BigBird and BSLongformer configs)."""
    nb = layout.shape[1]
    if nb < num_sliding_window_blocks:
        raise ValueError(
            f"num_sliding_window_blocks {num_sliding_window_blocks}"
            f" must be < number of block rows {nb}")
    w = num_sliding_window_blocks // 2
    row, col = _block_grid(nb)
    layout[h][np.abs(row - col) <= w] = 1
    return layout


class FixedSparsityConfig(SparsityConfig):
    """Fixed local windows + periodic global blocks (Sparse Transformers,
    arXiv:1904.10509; reference :94-241)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_local_blocks: int = 4,
                 num_global_blocks: int = 1,
                 attention: str = "bidirectional",
                 horizontal_global_attention: bool = False,
                 num_different_global_patterns: int = 1):
        super().__init__(num_heads, block, different_layout_per_head)
        if num_local_blocks % num_global_blocks != 0:
            raise ValueError(
                f"num_local_blocks {num_local_blocks} must be divisible by "
                f"num_global_blocks {num_global_blocks}")
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError(
                "only uni/bi-directional attention is supported")
        if attention != "bidirectional" and horizontal_global_attention:
            raise ValueError(
                "horizontal global attention requires bidirectional mode")
        if num_different_global_patterns > 1 and not different_layout_per_head:
            raise ValueError(
                "multiple global patterns require different_layout_per_head")
        if num_different_global_patterns > num_local_blocks // num_global_blocks:
            raise ValueError(
                f"num_different_global_patterns "
                f"{num_different_global_patterns} cannot exceed "
                f"{num_local_blocks // num_global_blocks}")
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.num_different_global_patterns = num_different_global_patterns

    def set_local_layout(self, h: int, layout: np.ndarray) -> np.ndarray:
        nb = layout.shape[1]
        row, col = _block_grid(nb)
        same_window = (row // self.num_local_blocks
                       == col // self.num_local_blocks)
        if self.attention == "unidirectional":
            same_window &= col <= row
        layout[h][same_window] = 1
        return layout

    def set_global_layout(self, h: int, layout: np.ndarray) -> np.ndarray:
        nb = layout.shape[1]
        lb, gb = self.num_local_blocks, self.num_global_blocks
        first = lb - (1 + h % self.num_different_global_patterns) * gb
        end = nb - (nb % lb)
        for i in range(first, end, lb):
            first_row = 0 if self.attention == "bidirectional" else i
            layout[h, first_row:, i:i + gb] = 1
            if self.horizontal_global_attention:
                layout[h, i:i + gb, :] = 1
        if end < nb:  # short trailing window
            start = min(end + first, nb - gb)
            first_row = 0 if self.attention == "bidirectional" else start
            layout[h, first_row:, start:start + gb] = 1
            if self.horizontal_global_attention:
                layout[h, start:start + gb, :] = 1
        return layout

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            self.set_local_layout(h, layout)
            self.set_global_layout(h, layout)
        return self.check_and_propagate_first_head_layout(layout)


class VariableSparsityConfig(SparsityConfig):
    """Fixed's generalization: per-window sizes, explicit global block
    indices/ranges, optional random blocks (reference :243-419)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_random_blocks: int = 0,
                 local_window_blocks: Optional[List[int]] = None,
                 global_block_indices: Optional[List[int]] = None,
                 global_block_end_indices: Optional[List[int]] = None,
                 attention: str = "bidirectional",
                 horizontal_global_attention: bool = False,
                 seed: int = 0):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = local_window_blocks or [4]
        self.global_block_indices = (global_block_indices
                                     if global_block_indices is not None
                                     else [0])
        if global_block_end_indices is not None:
            if len(self.global_block_indices) != len(global_block_end_indices):
                raise ValueError(
                    "global_block_indices and global_block_end_indices must "
                    "have equal length")
            for s, e in zip(self.global_block_indices,
                            global_block_end_indices):
                if s >= e:
                    raise ValueError(
                        f"global block start {s} must be < end {e}")
        self.global_block_end_indices = global_block_end_indices
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError(
                "only uni/bi-directional attention is supported")
        if attention != "bidirectional" and horizontal_global_attention:
            raise ValueError(
                "horizontal global attention requires bidirectional mode")
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.seed = seed

    def set_random_layout(self, h: int, layout: np.ndarray) -> np.ndarray:
        return _set_random_layout(h, layout, self.num_random_blocks,
                                  self.seed)

    def set_local_layout(self, h: int, layout: np.ndarray) -> np.ndarray:
        nb = layout.shape[1]
        start = 0
        for size in self.local_window_blocks:
            end = min(start + size, nb)
            self._fill_window(h, layout, start, end)
            start += size
        # tail: repeat the last window size
        size = self.local_window_blocks[-1]
        while start < nb:
            end = min(start + size, nb)
            self._fill_window(h, layout, start, end)
            start += size
        return layout

    def _fill_window(self, h, layout, start, end):
        for row in range(start, end):
            hi = row + 1 if self.attention == "unidirectional" else end
            layout[h, row, start:hi] = 1

    def set_global_layout(self, h: int, layout: np.ndarray) -> np.ndarray:
        nb = layout.shape[1]
        if self.global_block_end_indices is None:
            for idx in self.global_block_indices:
                if idx < nb:
                    if self.horizontal_global_attention:
                        layout[h, idx, :] = 1
                    first_row = (0 if self.attention == "bidirectional"
                                 else idx)
                    layout[h, first_row:, idx] = 1
        else:
            for s, e in zip(self.global_block_indices,
                            self.global_block_end_indices):
                if s < nb:
                    e = min(e, nb)
                    if self.horizontal_global_attention:
                        layout[h, s:e, :] = 1
                    first_row = 0 if self.attention == "bidirectional" else s
                    layout[h, first_row:, s:e] = 1
        return layout

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            self.set_random_layout(h, layout)
            self.set_local_layout(h, layout)
            self.set_global_layout(h, layout)
        return self.check_and_propagate_first_head_layout(layout)


class BigBirdSparsityConfig(SparsityConfig):
    """Random + sliding-window + global blocks (BigBird, arXiv:2007.14062;
    reference :421-543)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_random_blocks: int = 1,
                 num_sliding_window_blocks: int = 3,
                 num_global_blocks: int = 1,
                 seed: int = 0):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        self.seed = seed

    def set_random_layout(self, h: int, layout: np.ndarray) -> np.ndarray:
        return _set_random_layout(h, layout, self.num_random_blocks,
                                  self.seed)

    def set_sliding_window_layout(self, h: int,
                                  layout: np.ndarray) -> np.ndarray:
        return _set_sliding_window_layout(
            h, layout, self.num_sliding_window_blocks)

    def set_global_layout_itc(self, h: int,
                              layout: np.ndarray) -> np.ndarray:
        nb = layout.shape[1]
        if nb < self.num_global_blocks:
            raise ValueError(
                f"num_global_blocks {self.num_global_blocks} must be < "
                f"number of block rows {nb}")
        layout[h, :self.num_global_blocks, :] = 1
        layout[h, :, :self.num_global_blocks] = 1
        return layout

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            self.set_random_layout(h, layout)
            self.set_sliding_window_layout(h, layout)
            self.set_global_layout_itc(h, layout)
        return self.check_and_propagate_first_head_layout(layout)


class BSLongformerSparsityConfig(SparsityConfig):
    """Block-sparse Longformer: sliding window + designated global blocks
    (arXiv:2004.05150; reference :544-663)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_sliding_window_blocks: int = 3,
                 global_block_indices: Optional[List[int]] = None,
                 global_block_end_indices: Optional[List[int]] = None):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = (global_block_indices
                                     if global_block_indices is not None
                                     else [0])
        if global_block_end_indices is not None:
            if len(self.global_block_indices) != len(global_block_end_indices):
                raise ValueError(
                    "global_block_indices and global_block_end_indices must "
                    "have equal length")
            for s, e in zip(self.global_block_indices,
                            global_block_end_indices):
                if s >= e:
                    raise ValueError(
                        f"global block start {s} must be < end {e}")
        self.global_block_end_indices = global_block_end_indices

    def set_sliding_window_layout(self, h: int,
                                  layout: np.ndarray) -> np.ndarray:
        return _set_sliding_window_layout(
            h, layout, self.num_sliding_window_blocks)

    def set_global_layout(self, h: int, layout: np.ndarray) -> np.ndarray:
        nb = layout.shape[1]
        if self.global_block_end_indices is None:
            for idx in self.global_block_indices:
                if idx < nb:
                    layout[h, idx, :] = 1
                    layout[h, :, idx] = 1
        else:
            for s, e in zip(self.global_block_indices,
                            self.global_block_end_indices):
                if s < nb:
                    e = min(e, nb)
                    layout[h, s:e, :] = 1
                    layout[h, :, s:e] = 1
        return layout

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            self.set_sliding_window_layout(h, layout)
            self.set_global_layout(h, layout)
        return self.check_and_propagate_first_head_layout(layout)
