"""LR schedules as pure functions of the step counter — the port of
``deepspeed_tpu/runtime/lr_schedules.py`` (the reference's LRRangeTest,
OneCycle, WarmupLR and WarmupDecayLR as ``step -> lr``).

A schedule takes the step as a tensor (the optimizer's device step count)
or a Python int, and returns a 0-dim fp32 tensor on the step's device.
Branch-free torch ops with Python-float constants, as the JAX versions
are jnp: no value crosses between host and card.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

LR_SCHEDULE = "lr_schedule"
LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR, WARMUP_DECAY_LR]

Schedule = Callable[[torch.Tensor], torch.Tensor]


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def lr_range_test(lr_range_test_min_lr: float = 1e-3,
                  lr_range_test_step_size: int = 2000,
                  lr_range_test_step_rate: float = 1.0,
                  lr_range_test_staircase: bool = False) -> Schedule:
    """lr = min_lr * (1 + step_rate * step/step_size), optionally staircased."""
    def sched(step):
        ratio = _f32(step) / lr_range_test_step_size
        if lr_range_test_staircase:
            ratio = torch.floor(ratio)
        return lr_range_test_min_lr * (1.0 + lr_range_test_step_rate * ratio)
    return sched


def one_cycle(cycle_min_lr: float = 0.0,
              cycle_max_lr: float = 1e-2,
              cycle_first_step_size: int = 2000,
              cycle_second_step_size: int = None,
              cycle_first_stair_count: int = 0,
              cycle_second_stair_count: int = None,
              decay_step_size: int = 0,
              decay_lr_rate: float = 0.0,
              **_ignored_momentum_kwargs) -> Schedule:
    """Triangular one-cycle: min→max over the first phase, max→min over the
    second, then per-``decay_step_size`` decay by ``decay_lr_rate``.
    Momentum cycling kwargs are accepted for config parity only."""
    second = (cycle_second_step_size if cycle_second_step_size is not None
              else cycle_first_step_size)
    cycle_len = cycle_first_step_size + second

    def sched(step):
        s = _f32(step)
        in_cycle = s < cycle_len
        up = torch.clamp(s, max=cycle_first_step_size) / cycle_first_step_size
        down = torch.clamp((s - cycle_first_step_size) / second, 0.0, 1.0)
        tri = cycle_min_lr + (cycle_max_lr - cycle_min_lr) * (up - down)
        post = torch.clamp(s - cycle_len, min=0.0)
        if decay_step_size > 0:
            decays = torch.floor(post / decay_step_size)
        else:
            decays = post
        decayed = cycle_min_lr / (1.0 + decay_lr_rate * decays)
        return torch.where(in_cycle, tri, decayed)
    return sched


def warmup_lr(warmup_min_lr: float = 0.0,
              warmup_max_lr: float = 1e-3,
              warmup_num_steps: int = 1000,
              warmup_type: str = "log") -> Schedule:
    """min→max over warmup (log or linear interpolation), then constant.
    Log warmup interpolates by log(1+step)/log(1+warmup_num_steps)."""
    def sched(step):
        s = _f32(step)
        if warmup_type == "log":
            frac = torch.log1p(s) / math.log1p(warmup_num_steps)
        else:
            frac = s / max(warmup_num_steps, 1)
        frac = torch.clamp(frac, 0.0, 1.0)
        lr = warmup_min_lr + (warmup_max_lr - warmup_min_lr) * frac
        return torch.where(s >= warmup_num_steps,
                           torch.full_like(lr, warmup_max_lr), lr)
    return sched


def warmup_decay_lr(total_num_steps: int,
                    warmup_min_lr: float = 0.0,
                    warmup_max_lr: float = 1e-3,
                    warmup_num_steps: int = 1000,
                    warmup_type: str = "log") -> Schedule:
    """Warmup then linear decay to zero at ``total_num_steps``."""
    base = warmup_lr(warmup_min_lr, warmup_max_lr, warmup_num_steps,
                     warmup_type)

    def sched(step):
        s = _f32(step)
        decay = torch.clamp(
            (total_num_steps - s) / max(total_num_steps - warmup_num_steps,
                                        1), 0.0, 1.0)
        return torch.where(s <= warmup_num_steps, base(s),
                           warmup_max_lr * decay)
    return sched


_REGISTRY = {
    LR_RANGE_TEST: lr_range_test,
    ONE_CYCLE: one_cycle,
    WARMUP_LR: warmup_lr,
    WARMUP_DECAY_LR: warmup_decay_lr,
}


def get_lr_schedule(name: str, params: dict) -> Schedule:
    if name not in _REGISTRY:
        raise ValueError(
            f"Unknown lr schedule {name!r}; valid: {VALID_LR_SCHEDULES}")
    return _REGISTRY[name](**params)
