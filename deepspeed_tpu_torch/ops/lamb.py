"""Fused LAMB — the port of ``deepspeed_tpu/ops/lamb.py``: layerwise
adaptive rates with the trust ratio clamped to [min_coeff, max_coeff].

The JAX package computes the update with XLA and no Pallas kernel, so the
port computes it with torch ops on fp32 state.  The trust ratio is taken
per LEAF of the parameter tree, as the JAX ``tree.map`` takes it: a
stacked ``layers/*`` leaf of BERT gets one ratio over all its layers, not
one per layer, so the port's trajectory stays on the reference's.  The
step count and the learning rate stay device tensors: an update reads
nothing back to the host.

``fused_lamb(...)`` returns a ``GradientTransformation(init, update)``
over lists of tensors (``runtime.utils.tree_leaves`` order), as
``ops/adam.py::fused_adam`` does.
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from .adam import (GradientTransformation, ScalarOrSchedule, _lr_at,
                   adam_direction, adam_moments)


class FusedLambState(NamedTuple):
    count: torch.Tensor          # i32 device scalar: applied steps
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


def fused_lamb(lr: ScalarOrSchedule = 1e-3,
               betas: Tuple[float, float] = (0.9, 0.999),
               eps: float = 1e-8,
               weight_decay: float = 0.0,
               max_coeff: float = 10.0,
               min_coeff: float = 0.01,
               bias_correction: bool = True) -> GradientTransformation:
    b1, b2 = betas

    def init_fn(params):
        zeros = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        return FusedLambState(
            count=torch.zeros((), dtype=torch.int32,
                              device=params[0].device if params else None),
            mu=zeros, nu=[torch.zeros_like(z) for z in zeros])

    def update_fn(grads, state, params=None):
        if params is None:
            raise ValueError("fused_lamb requires params")
        count = state.count + 1
        step_lr = _lr_at(lr, count)
        mu, nu = adam_moments(grads, state.mu, state.nu, b1, b2)
        if bias_correction:
            c = count.float()
            c1, c2 = 1 - b1 ** c, 1 - b2 ** c
        else:
            c1 = c2 = 1.0
        updates = []
        for r, p in zip(adam_direction(mu, nu, c1, c2, eps), params):
            p32 = p.float()
            if weight_decay != 0.0:
                r = r + weight_decay * p32
            w_norm, r_norm = p32.norm(), r.norm()
            trust = torch.where((w_norm > 0) & (r_norm > 0),
                                (w_norm / r_norm).clamp(min_coeff,
                                                        max_coeff),
                                torch.ones_like(w_norm))
            updates.append(-step_lr * trust * r)
        return updates, FusedLambState(count=count, mu=mu, nu=nu)

    return GradientTransformation(init_fn, update_fn)


# reference-parity alias (deepspeed.ops.lamb.FusedLamb there)
FusedLamb = fused_lamb
