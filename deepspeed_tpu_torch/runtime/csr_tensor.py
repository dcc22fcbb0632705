"""CSR (IndexedSlices-style) sparse tensor for embedding gradients — the
port of ``deepspeed_tpu/runtime/csr_tensor.py``.

An embedding's gradient touches only the batch's token rows, so it
crosses the ``data`` ranks as (indices ``[nnz]``, values ``[nnz, ...]``)
gathered from every rank instead of a dense ``[vocab, d]`` all-reduce
(the reference's ``nn.Embedding`` CSR allreduce).  Duplicate indices sum
when densified, as gradients do.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..parallel import collectives as col
from ..parallel.mesh import DATA_AXIS


class CSRTensor:
    """Row-sparse view of a ``[num_rows, ...]`` tensor: ``values[i]`` is
    the dense row at ``indices[i]``."""

    def __init__(self, indices: torch.Tensor, values: torch.Tensor,
                 dense_shape: Tuple[int, ...]):
        self.indices = indices
        self.values = values
        self.dense_shape = tuple(dense_shape)

    @classmethod
    def from_dense(cls, dense: torch.Tensor,
                   max_nnz: int = None) -> "CSRTensor":
        """Rows with any nonzero become sparse rows, in row order (a
        stable sort of the used rows first), padded with row 0 and zero
        values up to ``max_nnz`` rows (all rows by default)."""
        num_rows = dense.shape[0]
        nnz = num_rows if max_nnz is None else max_nnz
        row_used = (dense != 0).reshape(num_rows, -1).any(dim=1)
        order = torch.argsort((~row_used).to(torch.uint8),
                              stable=True)[:nnz]
        valid = row_used[order]
        indices = torch.where(valid, order, 0)
        values = dense[order] * valid.reshape(
            (-1,) + (1,) * (dense.dim() - 1)).to(dense.dtype)
        return cls(indices.to(torch.int32), values, dense.shape)

    def to_dense(self) -> torch.Tensor:
        out = torch.zeros(self.dense_shape, dtype=self.values.dtype,
                          device=self.values.device)
        return out.index_add_(0, self.indices.long(), self.values)

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def sparse_size(self) -> int:
        """Elements stored sparsely (indices and values)."""
        return int(self.indices.numel() + self.values.numel())

    def __repr__(self):
        return (f"CSRTensor(nnz={self.indices.shape[0]}, "
                f"dense_shape={self.dense_shape})")


def csr_allgather(csr: CSRTensor, mesh, axis: str = DATA_AXIS) -> CSRTensor:
    """Every rank's (indices, values) over ``axis``, concatenated in axis
    order (the reference's padded allgather; the rows per rank are the
    same everywhere, so no padding).  Counted in ``csr_stats``."""
    idx = col.data_all_gather(csr.indices, mesh, col.csr_stats, axis)
    vals = col.data_all_gather(csr.values, mesh, col.csr_stats, axis)
    return CSRTensor(idx.reshape(-1),
                     vals.reshape((-1,) + tuple(vals.shape[2:])),
                     csr.dense_shape)


def sparse_embedding_grad(dense_grad: torch.Tensor,
                          token_ids: torch.Tensor) -> CSRTensor:
    """The CSR gradient of an embedding table from its dense gradient and
    the batch's token ids (the rows that can be nonzero): one entry per
    token.  A token that occurs k times carries its row / k in each
    entry, so ``to_dense`` rebuilds ``dense_grad`` and not k times it."""
    ids = token_ids.reshape(-1).to(torch.int32)
    rows = ids.long()
    counts = torch.zeros(dense_grad.shape[0], dtype=torch.float32,
                         device=dense_grad.device).index_add_(
        0, rows, torch.ones(rows.shape, dtype=torch.float32,
                            device=dense_grad.device))
    scale = (1.0 / counts[rows]).to(dense_grad.dtype)
    values = dense_grad[rows] * scale.reshape(
        (-1,) + (1,) * (dense_grad.dim() - 1))
    return CSRTensor(ids, values, dense_grad.shape)
