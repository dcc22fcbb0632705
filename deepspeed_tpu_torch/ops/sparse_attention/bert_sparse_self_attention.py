"""BERT-style sparse self-attention block — the port of
``deepspeed_tpu/ops/sparse_attention/bert_sparse_self_attention.py``.

Functional like the JAX layer: Q/K/V linear projections over a params dict
(``{"query"|"key"|"value": {"w": [d, d], "b": [d]}}``) and block-sparse
attention, with the incoming attention mask used as an additive
key-padding mask (the reference's default, an HF mask already in
-10000.0 form).  Without a mask the attention runs the block-sparse
kernels; with one it takes the gather path.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ...runtime.utils import params_from_numpy  # noqa: F401
from .sparse_self_attention import SparseSelfAttention
from .sparsity_config import FixedSparsityConfig, SparsityConfig


@dataclasses.dataclass(frozen=True)
class BertSelfAttentionConfig:
    hidden_size: int
    num_attention_heads: int

    @property
    def attention_head_size(self) -> int:
        if self.hidden_size % self.num_attention_heads != 0:
            raise ValueError(
                f"hidden size {self.hidden_size} is not a multiple of "
                f"attention heads {self.num_attention_heads}")
        return self.hidden_size // self.num_attention_heads


class BertSparseSelfAttention:
    """``__call__(params, hidden_states, attention_mask)`` → context
    [B, T, hidden] in hidden_states' dtype."""

    def __init__(self, config: BertSelfAttentionConfig,
                 sparsity_config: Optional[SparsityConfig] = None):
        self.config = config
        self.sparse_attn = SparseSelfAttention(
            sparsity_config or FixedSparsityConfig(
                num_heads=config.num_attention_heads),
            key_padding_mask_mode="add")

    def init(self, seed: int, device=None):
        """Random projections from ``seed`` (a ``torch.Generator`` on
        ``device``): the JAX init's distributions (normal 0.02 weights,
        zero biases), not its numbers."""
        d = self.config.hidden_size
        device = torch.device("cpu" if device is None else device)
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))

        def proj():
            return {"w": torch.randn((d, d), generator=gen, device=device)
                    * 0.02,
                    "b": torch.zeros((d,), device=device)}

        return {"query": proj(), "key": proj(), "value": proj()}

    def _split_heads(self, x):
        B, T, _ = x.shape
        H = self.config.num_attention_heads
        Dh = self.config.attention_head_size
        return x.reshape(B, T, H, Dh).transpose(1, 2)

    def __call__(self, params, hidden_states, attention_mask=None):
        dt = hidden_states.dtype

        def proj(p):
            return hidden_states @ p["w"].to(dt) + p["b"].to(dt)

        q, k, v = (self._split_heads(proj(params[n]))
                   for n in ("query", "key", "value"))
        ctx = self.sparse_attn(q, k, v, key_padding_mask=attention_mask)
        B, H, T, Dh = ctx.shape
        return ctx.transpose(1, 2).reshape(B, T, H * Dh)
