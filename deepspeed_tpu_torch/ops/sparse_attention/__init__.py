"""Block-sparse attention — the port of ``deepspeed_tpu.ops.sparse_attention``
(the reference's long-sequence feature slot).  ``MatMul``/``Softmax``
(``matmul.py``: gather and matmul, no kernel) are not ported yet:
ROADMAP.md queue 1, item 13."""
from .sparsity_config import (BigBirdSparsityConfig,
                              BSLongformerSparsityConfig,
                              DenseSparsityConfig, FixedSparsityConfig,
                              SparsityConfig, VariableSparsityConfig)
from .sparse_self_attention import SparseSelfAttention, build_lut
from .bert_sparse_self_attention import (BertSelfAttentionConfig,
                                         BertSparseSelfAttention)
from .sparse_attention_utils import SparseAttentionUtils

__all__ = [
    "BigBirdSparsityConfig", "BSLongformerSparsityConfig",
    "DenseSparsityConfig", "FixedSparsityConfig", "SparsityConfig",
    "VariableSparsityConfig", "SparseSelfAttention", "build_lut",
    "BertSelfAttentionConfig", "BertSparseSelfAttention",
    "SparseAttentionUtils",
]
