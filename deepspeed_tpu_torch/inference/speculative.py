"""Next-token selection and greedy draft-verify acceptance (port of
``deepspeed_tpu/inference/speculative.py``: ``select_next_token``,
``greedy_accept`` and ``speculative_accept`` at temperature 0).

A small draft model proposes ``k`` tokens per serving tick; the target
scores all ``k+1`` positions in one verify pass, and :func:`greedy_accept`
decides on the device how many proposals survive: proposal ``i`` survives
iff it equals the target's argmax at the previous position, and the tick
emits the target's argmaxes over the accepted prefix plus one bonus token.
The emitted stream is therefore the non-speculative greedy stream, token
for token.

Sampling (``temperature > 0``) and its rejection-sampling acceptance are
not ported: ``jax.random`` streams cannot be replayed in torch, so that
arm needs a statistical bar of its own (ROADMAP.md queue 1, item 7.3).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _refuse_sampling(what: str, temperature: float) -> None:
    if temperature and temperature > 0.0:
        raise NotImplementedError(
            f"{what} with temperature > 0 (sampling) is not ported yet: "
            "ROADMAP.md queue 1, item 7.3 (speculation and sampling)")


def select_next_token(logits: torch.Tensor, temperature: float = 0.0,
                      rng=None) -> torch.Tensor:
    """Greedy next token over ``[..., vocab]`` logits: the argmax, first
    index on ties, as int32."""
    _refuse_sampling("select_next_token", temperature)
    return torch.argmax(logits, dim=-1).to(torch.int32)


def greedy_accept(target_logits: torch.Tensor, draft_tokens: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy draft-verify acceptance (reference ``speculative.py:63-84``).

    target_logits [S, W, V] — row ``i`` scores the token after the pass's
    ``i``-th input token (the pending token, then the ``k = W-1``
    proposals); draft_tokens [S, k].

    Returns ``(out_tokens [S, W] int32, accepted [S] int32)``: the tick
    emits ``out_tokens[s, :accepted[s] + 1]`` — the target argmaxes of the
    longest proposal prefix that matches them, plus the bonus token."""
    g = torch.argmax(target_logits, dim=-1).to(torch.int32)     # [S, W]
    k = draft_tokens.shape[1]
    ok = draft_tokens.to(torch.int32) == g[:, :k]               # [S, k]
    keep = torch.cumprod(ok.to(torch.int32), dim=1)
    return g, keep.sum(dim=1).to(torch.int32)


def speculative_accept(target_logits: torch.Tensor,
                       draft_tokens: torch.Tensor,
                       draft_probs: Optional[torch.Tensor],
                       temperature: float,
                       rng=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's dispatch between the acceptance arms: greedy at
    ``temperature == 0`` (``draft_probs``/``rng`` unused); the
    rejection-sampling arm raises (not ported)."""
    _refuse_sampling("speculative_accept", temperature)
    return greedy_accept(target_logits, draft_tokens)
