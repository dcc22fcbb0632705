"""Attention ops — the dense arm.

Port of ``deepspeed_tpu/ops/attention.py``'s ``causal_attention`` at
inference (no dropout): the reference path the serving prefill takes with
``attn_impl="dense"``; ``ops/kernels/flash_attention.py`` replaces it on
the default ``"flash"`` path.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: Optional[torch.Tensor] = None,
                     sm_scale: Optional[float] = None) -> torch.Tensor:
    """Multi-head causal attention over q, k, v [B, H, T, Dh].  Scores and
    softmax run in fp32, the probabilities are cast to q.dtype before the
    value product, and the result is q.dtype — the JAX package's op order.
    ``mask``: optional boolean [.., T, T] (True = attend) on top of the
    causal mask."""
    B, H, T, Dh = q.shape
    scale = (float(np.float32(sm_scale)) if sm_scale is not None
             else float(np.float32(1.0) / np.sqrt(np.float32(Dh))))
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    causal = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                   device=q.device))
    neg = torch.finfo(torch.float32).min
    scores = torch.where(causal, scores, neg)
    if mask is not None:
        scores = torch.where(mask, scores, neg)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)
