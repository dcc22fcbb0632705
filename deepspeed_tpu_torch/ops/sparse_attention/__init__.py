"""Block-sparse attention — the port of ``deepspeed_tpu.ops.sparse_attention``
(the reference's long-sequence feature slot): the sparsity configs, the
attention modules over the block-sparse kernels, and the standalone
``MatMul``/``Softmax`` ops (``matmul.py``: a gather and one batched
product, torch ops as in the JAX package, no kernel)."""
from .sparsity_config import (BigBirdSparsityConfig,
                              BSLongformerSparsityConfig,
                              DenseSparsityConfig, FixedSparsityConfig,
                              SparsityConfig, VariableSparsityConfig)
from .sparse_self_attention import SparseSelfAttention, build_lut
from .bert_sparse_self_attention import (BertSelfAttentionConfig,
                                         BertSparseSelfAttention)
from .sparse_attention_utils import SparseAttentionUtils
from .matmul import MatMul, Softmax

__all__ = [
    "BigBirdSparsityConfig", "BSLongformerSparsityConfig",
    "DenseSparsityConfig", "FixedSparsityConfig", "SparsityConfig",
    "VariableSparsityConfig", "SparseSelfAttention", "build_lut",
    "BertSelfAttentionConfig", "BertSparseSelfAttention",
    "SparseAttentionUtils", "MatMul", "Softmax",
]
