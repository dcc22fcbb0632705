"""Mixed precision and loss scaling as device state — the port of
``deepspeed_tpu/runtime/precision.py``.

Static scale, and dynamic scaling with a growth window and hysteresis
(the reference's "delayed shift").  As in the JAX package the
overflow → skip → rescale decision is data: ``LossScaleState`` holds
device tensors and ``update_scale`` is branch-free (``torch.where``), so
a training step never reads a value back to the host to decide.
``LossScaleConfig`` is the static Python half.

bf16 needs no loss scaling: ``make_loss_scaler(enabled=False)`` yields a
unit scale and ``update_scale`` becomes the identity.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch


class LossScaleState(NamedTuple):
    """Device state (0-dim tensors)."""
    loss_scale: torch.Tensor     # f32
    good_steps: torch.Tensor     # i32 — consecutive overflow-free steps
    hysteresis: torch.Tensor     # i32 — overflows left before scale halves


@dataclasses.dataclass(frozen=True)
class LossScaleConfig:
    """Static knobs."""
    dynamic: bool = True
    scale_window: int = 1000
    min_scale: float = 1.0
    init_hysteresis: int = 2
    enabled: bool = True


def make_loss_scaler(enabled: bool = True,
                     static_scale: float = 0,
                     initial_scale_power: int = 32,
                     scale_window: int = 1000,
                     hysteresis: int = 2,
                     min_scale: float = 1.0,
                     device=None
                     ) -> Tuple[LossScaleState, LossScaleConfig]:
    """``static_scale == 0`` selects dynamic scaling (reference semantics:
    fp16.loss_scale == 0 ⇒ dynamic)."""
    dynamic = static_scale == 0
    init = float(2 ** initial_scale_power) if dynamic else float(static_scale)
    if not enabled:
        init = 1.0
    state = LossScaleState(
        loss_scale=torch.tensor(init, dtype=torch.float32, device=device),
        good_steps=torch.tensor(0, dtype=torch.int32, device=device),
        hysteresis=torch.tensor(hysteresis, dtype=torch.int32,
                                device=device),
    )
    config = LossScaleConfig(
        dynamic=dynamic and enabled,
        scale_window=scale_window,
        min_scale=min_scale,
        init_hysteresis=hysteresis,
        enabled=enabled,
    )
    return state, config


def from_fp16_config(fp16_cfg, device=None
                     ) -> Tuple[LossScaleState, LossScaleConfig]:
    """Build from a DeepSpeedFP16Config block."""
    return make_loss_scaler(
        enabled=fp16_cfg.enabled,
        static_scale=fp16_cfg.loss_scale,
        initial_scale_power=fp16_cfg.initial_scale_power,
        scale_window=fp16_cfg.loss_scale_window,
        hysteresis=fp16_cfg.hysteresis,
        min_scale=fp16_cfg.min_loss_scale,
        device=device,
    )


def scale_loss(loss: torch.Tensor, state: LossScaleState) -> torch.Tensor:
    return loss * state.loss_scale.to(loss.dtype)


def unscale_grads(grads, state: LossScaleState):
    """fp32 copies of ``grads`` (a list of tensors) divided by the scale."""
    inv = (1.0 / state.loss_scale).float()
    return [g.float() * inv for g in grads]


def grads_finite(grads) -> torch.Tensor:
    """One device bool: every element of every gradient is finite."""
    if not grads:
        return torch.tensor(True)
    return torch.stack([torch.isfinite(g).all() for g in grads]).all()


def update_scale(state: LossScaleState, finite: torch.Tensor,
                 config: LossScaleConfig) -> LossScaleState:
    """One dynamic-loss-scale transition (reference: loss_scaler.py:151-166),
    both branches computed and selected by ``finite`` on the device."""
    if not config.dynamic:
        return state
    # overflow-free step: count it; a full window doubles the scale and
    # replenishes the hysteresis
    good = state.good_steps + 1
    grow = good >= config.scale_window
    g_scale = torch.where(grow, state.loss_scale * 2.0, state.loss_scale)
    g_good = torch.where(grow, torch.zeros_like(good), good)
    g_hys = torch.where(grow, torch.full_like(state.hysteresis,
                                              config.init_hysteresis),
                        state.hysteresis)
    # overflow: spend one hysteresis; at zero halve (floored) and refill
    hys = state.hysteresis - 1
    drop = hys <= 0
    o_scale = torch.where(
        drop, torch.clamp(state.loss_scale / 2.0, min=config.min_scale),
        state.loss_scale)
    o_hys = torch.where(drop, torch.full_like(hys, config.init_hysteresis),
                        hys)
    return LossScaleState(
        loss_scale=torch.where(finite, g_scale, o_scale),
        good_steps=torch.where(finite, g_good, torch.zeros_like(good)),
        hysteresis=torch.where(finite, g_hys, o_hys))


def select_compute_dtype(fp16_enabled: bool, bf16_enabled: bool):
    if bf16_enabled:
        return torch.bfloat16
    if fp16_enabled:
        return torch.float16
    return torch.float32


def cast_to_compute(params, dtype):
    """fp32 master → compute-dtype params (floating leaves only; a
    differentiable cast, so gradients flow back to the fp32 leaves in
    fp32)."""
    if isinstance(params, dict):
        return {k: cast_to_compute(v, dtype) for k, v in params.items()}
    if params.is_floating_point():
        return params.to(dtype)
    return params
