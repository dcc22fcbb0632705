"""Progressive Layer Drop — the port's copy of
``deepspeed_tpu/runtime/progressive_layer_drop.py`` (reference
deepspeed/runtime/progressive_layer_drop.py).

Keep-probability schedule θ(t) = (1−θ̄)·exp(−γ·t) + θ̄; the engine advances
it each step and puts θ into the batch, and the model draws each layer's
keep decision (``models/bert.py``).  This class is bookkeeping only.
"""
from __future__ import annotations

import math

from ..utils.logging import log_dist


class ProgressiveLayerDrop:
    def __init__(self, theta: float = 0.5, gamma: float = 0.001):
        self.theta = theta
        self.gamma = gamma
        self.current_theta = 1.0
        log_dist(f"Enabled progressive layer dropping (theta = "
                 f"{self.theta})", ranks=[0])

    def get_state(self) -> dict:
        return {"progressive_layer_drop": True,
                "pld_theta": self.get_theta()}

    def get_theta(self) -> float:
        return self.current_theta

    def update_state(self, global_step: int) -> None:
        def _prob(x, gamma, p):
            return (1.0 - p) * math.exp(-gamma * x) + p

        self.current_theta = _prob(global_step, self.gamma, self.theta)
