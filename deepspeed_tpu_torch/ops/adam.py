"""Fused Adam/AdamW — the port of ``deepspeed_tpu/ops/adam.py``.

The JAX package computes the update with XLA and no Pallas kernel, so the
port computes it with ordinary torch ops on fp32 state: the value kept is
the exact update rule and the knob surface (``adam_w_mode``,
``bias_correction``, a weight-decay mask, an lr schedule), not kernel
plumbing.  The step count and the learning rate stay device tensors, so
an update never reads a value back to the host.

``fused_adam(...)`` returns a ``GradientTransformation(init, update)``:
``init(params)`` builds the state and ``update(grads, state, params)``
returns ``(updates, new_state)`` with ``updates = -lr · direction`` — the
optax contract of the JAX package.  Parameters and gradients are lists of
tensors (``runtime.utils.tree_leaves`` order).
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple, Union

import torch

ScalarOrSchedule = Union[float, Callable[[torch.Tensor], torch.Tensor]]


class FusedAdamState(NamedTuple):
    count: torch.Tensor          # i32 device scalar: applied steps
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


def _lr_at(lr: ScalarOrSchedule, count: torch.Tensor) -> torch.Tensor:
    if callable(lr):
        return torch.as_tensor(lr(count), dtype=torch.float32,
                               device=count.device)
    # a fill kernel: a tensor copied from the host would sync the stream
    return torch.full((), float(lr), dtype=torch.float32,
                      device=count.device)


def adam_moments(grads, mu, nu, b1: float, b2: float):
    """One EMA step of the first/second moments."""
    mu2 = [b1 * m + (1 - b1) * g for m, g in zip(mu, grads)]
    nu2 = [b2 * v + (1 - b2) * (g * g) for v, g in zip(nu, grads)]
    return mu2, nu2


def adam_direction(mu, nu, c1, c2, eps: float):
    """Bias-corrected update direction m̂/(√v̂+eps); c1/c2 are the bias
    correction denominators (pass 1.0 to disable)."""
    return [(m / c1) / (torch.sqrt(v / c2) + eps) for m, v in zip(mu, nu)]


def fused_adam(lr: ScalarOrSchedule = 1e-3,
               betas: Tuple[float, float] = (0.9, 0.999),
               eps: float = 1e-8,
               weight_decay: float = 0.0,
               adam_w_mode: bool = True,
               bias_correction: bool = True,
               weight_decay_mask: Optional[Callable] = None
               ) -> GradientTransformation:
    """AdamW (``adam_w_mode=True``, decoupled decay) or classic Adam with L2
    folded into the gradient (``adam_w_mode=False``).
    ``weight_decay_mask(params) -> list of bools`` optionally exempts
    leaves (e.g. biases / LayerNorm scales) from decay."""
    b1, b2 = betas

    def init_fn(params):
        zeros = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        return FusedAdamState(
            count=torch.zeros((), dtype=torch.int32,
                              device=params[0].device if params else None),
            mu=zeros, nu=[torch.zeros_like(z) for z in zeros])

    def decay_mask(params):
        return (weight_decay_mask(params) if weight_decay_mask
                else [True] * len(params))

    def update_fn(grads, state, params=None):
        if params is None:
            raise ValueError("fused_adam requires params for weight decay")
        count = state.count + 1
        step_lr = _lr_at(lr, count)
        if weight_decay != 0.0 and not adam_w_mode:
            grads = [g + weight_decay * p if m else g
                     for g, p, m in zip(grads, params, decay_mask(params))]
        mu, nu = adam_moments(grads, state.mu, state.nu, b1, b2)
        if bias_correction:
            c = count.float()
            c1, c2 = 1 - b1 ** c, 1 - b2 ** c
        else:
            c1 = c2 = 1.0
        updates = adam_direction(mu, nu, c1, c2, eps)
        if weight_decay != 0.0 and adam_w_mode:
            updates = [u + weight_decay * p.to(u.dtype) if m else u
                       for u, p, m in zip(updates, params,
                                          decay_mask(params))]
        updates = [-step_lr * u for u in updates]
        return updates, FusedAdamState(count=count, mu=mu, nu=nu)

    return GradientTransformation(init_fn, update_fn)

