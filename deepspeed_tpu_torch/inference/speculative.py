"""Next-token selection (port of ``deepspeed_tpu/inference/
speculative.py``'s ``select_next_token``, greedy arm).

Sampling (``temperature > 0``) and the draft-verify acceptance rules come
with speculation (ROADMAP.md queue 1, item 7.3).
"""
from __future__ import annotations

import torch


def select_next_token(logits: torch.Tensor, temperature: float = 0.0,
                      rng=None) -> torch.Tensor:
    """Greedy next token over ``[..., vocab]`` logits: the argmax, first
    index on ties, as int32."""
    if temperature and temperature > 0.0:
        raise NotImplementedError(
            "select_next_token with temperature > 0 (sampling) is not "
            "ported yet: ROADMAP.md queue 1, item 7.3 (speculation and "
            "sampling)")
    return torch.argmax(logits, dim=-1).to(torch.int32)
