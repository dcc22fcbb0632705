"""Next-token selection and draft-verify acceptance (port of
``deepspeed_tpu/inference/speculative.py``: ``select_next_token``,
``greedy_accept``, ``rejection_sample_accept`` and ``speculative_accept``).

A small draft model proposes ``k`` tokens per serving tick; the target
scores all ``k+1`` positions in one verify pass, and the acceptance runs on
the device.  Two arms, chosen by the engine's fixed ``serving.temperature``:

* ``temperature == 0`` — greedy: proposal ``i`` survives iff it equals the
  target's argmax at the previous position, and the tick emits the
  target's argmaxes over the accepted prefix plus one bonus token, so the
  emitted stream is the non-speculative greedy stream token for token.
  No generator is built and no random op runs.
* ``temperature > 0`` — the rejection-sampling rule of Chen et al. 2023:
  accept proposal ``x`` with probability ``min(1, p(x)/q(x))``, resample
  the first rejection from ``normalize(max(p - q, 0))``, and sample the
  bonus from ``p`` on full acceptance; the emitted tokens are distributed
  as ancestral sampling from the target.

Randomness: ``rng`` is a ``torch.Generator`` on the logits' device, built
by the caller from a host seed (the engine derives one seed per program
call with ``runtime.utils.fold_in``), never the global generator.  A
categorical draw is Gumbel-max, ``argmax(logits + G)``, as
``jax.random.categorical`` draws it; ``jax.random``'s bits cannot be
replayed in torch, so the two packages agree in distribution, and the
port is bitwise reproducible against itself for a given seed.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _gumbel(shape, rng: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))`` in fp32; ``u`` is kept in
    ``[tiny, 1)`` so that neither log sees 0 and no NaN or +inf appears."""
    u = torch.rand(shape, generator=rng, device=device, dtype=torch.float32)
    u.clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _categorical(logits: torch.Tensor, rng: torch.Generator) -> torch.Tensor:
    """One draw per row of ``softmax(logits)`` over the last axis (fp32
    logits; ``-inf`` entries are never picked)."""
    return torch.argmax(logits + _gumbel(logits.shape, rng, logits.device),
                        dim=-1).to(torch.int32)


def select_next_token(logits: torch.Tensor, temperature: float = 0.0,
                      rng: Optional[torch.Generator] = None) -> torch.Tensor:
    """The next-token rule every serving emission site shares, over
    ``[..., vocab]`` logits, as int32.

    ``temperature == 0`` is greedy — the argmax, first index on ties — and
    takes no generator.  ``temperature > 0`` samples ``softmax(logits /
    temperature)`` (the logits cast to fp32 first, as the reference casts
    them) with ``rng``."""
    if temperature and temperature > 0.0:
        if rng is None:
            raise ValueError(
                "select_next_token with temperature > 0 needs an rng "
                "generator")
        return _categorical(logits.float() / temperature, rng)
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


def rejection_sample_accept(target_logits: torch.Tensor,
                            draft_tokens: torch.Tensor,
                            draft_probs: torch.Tensor,
                            temperature: float,
                            rng: torch.Generator
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Speculative sampling acceptance (reference ``speculative.py:87-138``).

    target_logits [S, W, V]; draft_tokens [S, k]; draft_probs [S, k, V] —
    the proposal distributions ``q_i`` the draft sampled from.

    Position ``i`` accepts ``x = draft_tokens[:, i]`` iff ``u * q_i(x) <=
    p_i(x)`` (``u`` uniform); the first rejection resamples from
    ``normalize(max(p_i - q_i, 0))`` (``p_i`` itself where that residual is
    all zeros, i.e. p == q), and full acceptance samples the bonus from
    ``p_k``.  The uniforms are drawn first, then one Gumbel field over the
    ``[S, W, V]`` replacement distributions, both from ``rng``.

    Returns ``(out_tokens [S, W] int32, accepted [S] int32)`` with
    :func:`greedy_accept`'s contract."""
    S, W, V = target_logits.shape
    k = W - 1
    dev = target_logits.device
    p = torch.softmax(target_logits.float() / float(temperature), dim=-1)
    q = draft_probs.float()                                     # [S, k, V]
    d = draft_tokens.long()                                     # [S, k]
    p_d = torch.gather(p[:, :k], 2, d[..., None])[..., 0]       # p_i(d_i)
    q_d = torch.gather(q, 2, d[..., None])[..., 0]
    u = torch.rand((S, k), generator=rng, device=dev, dtype=torch.float32)
    ok = u * q_d <= p_d                                         # [S, k]
    keep = torch.cumprod(ok.to(torch.int32), dim=1)
    accepted = keep.sum(dim=1).to(torch.int32)                  # [S]
    # the replacement token for every possible stop position at once:
    # positions 0..k-1 resample the residual, position k samples the bonus
    # from p_k — one categorical per row
    resid = torch.clamp(p[:, :k] - q, min=0.0)
    rsum = resid.sum(dim=-1, keepdim=True)
    resid = torch.where(rsum > 0.0,
                        resid / torch.where(rsum > 0.0, rsum, 1.0), p[:, :k])
    repl_dist = torch.cat([resid, p[:, k:]], dim=1)             # [S, W, V]
    # log of exact zeros -> -inf: "never pick this"
    repl = _categorical(torch.log(repl_dist), rng)              # [S, W]
    out = torch.cat([d.to(torch.int32), repl[:, k:k + 1]], dim=1)
    rows = torch.arange(S, device=dev)
    acc = accepted.long()
    out[rows, acc] = repl[rows, acc]
    return out, accepted


def speculative_accept(target_logits: torch.Tensor,
                       draft_tokens: torch.Tensor,
                       draft_probs: Optional[torch.Tensor],
                       temperature: float,
                       rng: Optional[torch.Generator] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dispatch between the two arms: greedy at ``temperature == 0``
    (``draft_probs``/``rng`` unused), rejection sampling otherwise."""
    if temperature and temperature > 0.0:
        if draft_probs is None or rng is None:
            raise ValueError(
                "speculative_accept with temperature > 0 needs the "
                "draft's proposal distributions and an rng generator")
        return rejection_sample_accept(target_logits, draft_tokens,
                                       draft_probs, temperature, rng)
    return greedy_accept(target_logits, draft_tokens)
