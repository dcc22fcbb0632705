"""LR schedules as pure functions of the step counter — the port of
``deepspeed_tpu/runtime/lr_schedules.py`` (the reference's LRRangeTest,
OneCycle, WarmupLR and WarmupDecayLR as ``step -> lr``).

A schedule takes the step as a tensor (the optimizer's device step count)
or a Python int, and returns a 0-dim fp32 tensor on the step's device.
Branch-free torch ops with Python-float constants, as the JAX versions
are jnp: no value crosses between host and card.

The convergence-tuning CLI flags (``add_tuning_arguments``,
``parse_arguments``, ``schedule_params_from_args``) are a copy of the JAX
package's.
"""
from __future__ import annotations

import argparse
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


def _str2bool(v) -> bool:
    """argparse bool that honors 'false'/'0' (plain ``type=bool`` would
    parse any non-empty string — including 'False' — as True)."""
    if isinstance(v, bool):
        return v
    if v.lower() in ("true", "t", "yes", "y", "1"):
        return True
    if v.lower() in ("false", "f", "no", "n", "0"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")


def add_tuning_arguments(parser: argparse.ArgumentParser):
    """Convergence-tuning CLI flags (reference: lr_schedules.py:54-152).

    Same flag names and defaults so existing launch scripts keep working;
    ``override_lr_schedule_config`` turns the parsed namespace back into a
    scheduler config block.
    """
    group = parser.add_argument_group(
        "Convergence Tuning", "Convergence tuning configurations")
    group.add_argument("--lr_schedule", type=str, default=None,
                       help="LR schedule for training.")
    # Learning rate range test
    group.add_argument("--lr_range_test_min_lr", type=float, default=0.001,
                       help="Starting lr value.")
    group.add_argument("--lr_range_test_step_rate", type=float, default=1.0,
                       help="scaling rate for LR range test.")
    group.add_argument("--lr_range_test_step_size", type=int, default=1000,
                       help="training steps per LR change.")
    group.add_argument("--lr_range_test_staircase", type=_str2bool,
                       default=False,
                       help="use staircase scaling for LR range test.")
    # OneCycle phase sizes
    group.add_argument("--cycle_first_step_size", type=int, default=1000,
                       help="size of first step of 1Cycle schedule.")
    group.add_argument("--cycle_first_stair_count", type=int, default=-1,
                       help="first stair count for 1Cycle schedule.")
    group.add_argument("--cycle_second_step_size", type=int, default=-1,
                       help="size of second step (default first_step_size).")
    group.add_argument("--cycle_second_stair_count", type=int, default=-1,
                       help="second stair count for 1Cycle schedule.")
    group.add_argument("--decay_step_size", type=int, default=1000,
                       help="intervals for applying post-cycle decay.")
    # OneCycle LR
    group.add_argument("--cycle_min_lr", type=float, default=0.01,
                       help="1Cycle LR lower bound.")
    group.add_argument("--cycle_max_lr", type=float, default=0.1,
                       help="1Cycle LR upper bound.")
    group.add_argument("--decay_lr_rate", type=float, default=0.0,
                       help="post cycle LR decay rate.")
    # OneCycle momentum
    group.add_argument("--cycle_momentum", default=False,
                       action="store_true",
                       help="Enable 1Cycle momentum schedule.")
    group.add_argument("--cycle_min_mom", type=float, default=0.8,
                       help="1Cycle momentum lower bound.")
    group.add_argument("--cycle_max_mom", type=float, default=0.9,
                       help="1Cycle momentum upper bound.")
    group.add_argument("--decay_mom_rate", type=float, default=0.0,
                       help="post cycle momentum decay rate.")
    # Warmup
    group.add_argument("--warmup_min_lr", type=float, default=0,
                       help="WarmupLR minimum/initial LR value")
    group.add_argument("--warmup_max_lr", type=float, default=0.001,
                       help="WarmupLR maximum LR value.")
    group.add_argument("--warmup_num_steps", type=int, default=1000,
                       help="WarmupLR step count for LR warmup.")
    group.add_argument("--total_num_steps", type=int, default=None,
                       help="WarmupDecayLR total training step count "
                            "(decay reaches zero here).")
    return parser


def parse_arguments():
    """Parse only the tuning flags (reference: lr_schedules.py:155-160)."""
    parser = argparse.ArgumentParser()
    parser = add_tuning_arguments(parser)
    return parser.parse_known_args()


def schedule_params_from_args(args) -> dict | None:
    """Turn a parsed tuning namespace into a ``scheduler`` config block
    (the reference consumes these flags through its config override path,
    lr_schedules.py:163-216).  Returns None when --lr_schedule is unset."""
    name = getattr(args, "lr_schedule", None)
    if not name:
        return None
    prefixes = {
        LR_RANGE_TEST: ("lr_range_test_",),
        ONE_CYCLE: ("cycle_", "decay_"),
        WARMUP_LR: ("warmup_",),
        WARMUP_DECAY_LR: ("warmup_", "total_num_steps"),
    }
    if name not in prefixes:
        raise ValueError(
            f"Unknown lr schedule {name!r}; valid: {VALID_LR_SCHEDULES}")
    params = {}
    for key, val in vars(args).items():
        if val is None or key == LR_SCHEDULE:
            continue
        if any(key.startswith(p) for p in prefixes[name]):
            # argparse's -1 sentinels mean "unset" in the reference
            if isinstance(val, int) and val == -1:
                continue
            params[key] = val
    if name == WARMUP_DECAY_LR and "total_num_steps" not in params:
        raise ValueError(
            "--lr_schedule WarmupDecayLR requires --total_num_steps")
    return {"type": name, "params": params}
