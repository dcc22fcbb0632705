"""Attention ops — the dense arm.

Port of ``deepspeed_tpu/ops/attention.py``'s ``causal_attention``: the
reference path the model takes with ``attn_impl="dense"`` (prefill and
training) and the parity reference of the flash kernels
(``ops/kernels/flash_attention.py``), which replace it on the default
``"flash"`` path.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     dropout_rate: float = 0.0,
                     dropout_rng: Optional[torch.Generator] = None,
                     mask: Optional[torch.Tensor] = None,
                     sm_scale: Optional[float] = None,
                     dropout_keep: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Multi-head causal attention over q, k, v [B, H, T, Dh].  Scores and
    softmax run in fp32, the probabilities are cast to q.dtype before the
    value product, and the result is q.dtype — the JAX package's op order.
    ``mask``: optional boolean [.., T, T] (True = attend) on top of the
    causal mask.

    ``dropout_keep`` (a precomputed boolean keep mask, e.g. the flash
    kernel's position hash) takes precedence over a Bernoulli draw from
    ``dropout_rng``, a ``torch.Generator`` on q's device — callers use it
    to keep dropout realizations identical across the dense and flash
    arms."""
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
    probs = torch.softmax(scores, dim=-1)
    if dropout_rate > 0.0 and dropout_keep is None \
            and dropout_rng is not None:
        dropout_keep = torch.rand(probs.shape, generator=dropout_rng,
                                  device=q.device) < 1.0 - dropout_rate
    if dropout_rate > 0.0 and dropout_keep is not None:
        probs = torch.where(dropout_keep, probs / (1.0 - dropout_rate), 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(q.dtype), v)
