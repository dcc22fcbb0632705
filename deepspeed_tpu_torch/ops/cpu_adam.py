"""DeepSpeedCPUAdam — the host-resident fused Adam of the offload tier, the
port of ``deepspeed_tpu/ops/cpu_adam.py``.

It binds ``ds_cpu_adam_step`` (``csrc/cpu_adam.cpp``, built by
``ops/op_builder.py``) through ctypes on the data pointers of contiguous
fp32 CPU tensors: the master and both moments update in place, and the
same pass writes the updated parameter's bf16/fp16 copy (the upload
copy) into a caller-given buffer — the reference's fused fp16 copy-back.
The call releases the GIL.  OpenMP's threads are capped at torch's
intra-op thread count (``omp_threads``), so the two pools never
oversubscribe the cores between them.  The numpy arm (no toolchain)
computes the same rule; :attr:`is_native` says which arm runs.
"""
from __future__ import annotations

import contextlib
import ctypes
import os
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..utils.logging import logger
from .op_builder import OpBuilderError, load_cpu_ops

ScalarOrSchedule = Union[float, Callable]

_LOWP_NONE, _LOWP_BF16, _LOWP_FP16 = 0, 1, 2
_LOWP_DTYPES = {_LOWP_BF16: torch.bfloat16, _LOWP_FP16: torch.float16}


def lowp_kind(dtype: Optional[torch.dtype]) -> int:
    """The kernel's low-precision selector for an upload dtype (None or
    fp32: no copy written)."""
    return {torch.bfloat16: _LOWP_BF16,
            torch.float16: _LOWP_FP16}.get(dtype, _LOWP_NONE)


def _ptr(t: torch.Tensor, typ):
    return ctypes.cast(t.data_ptr(), ctypes.POINTER(typ))


class DeepSpeedCPUAdam:
    """Fused host Adam over lists of contiguous fp32 CPU tensors; each
    leaf's moments are created at its first step."""

    def __init__(self, lr: ScalarOrSchedule = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8,
                 weight_decay: float = 0.0,
                 adamw_mode: bool = True,
                 bias_correction: bool = True,
                 use_native: Optional[bool] = None):
        self.lr = lr
        self.betas = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.adamw_mode = adamw_mode
        self.bias_correction = bias_correction
        self.step_count = 0
        if use_native is None:
            try:
                self._lib = load_cpu_ops()
            except OpBuilderError as e:
                logger.warning("DeepSpeedCPUAdam: the native Adam did not "
                               "build (%s); the numpy arm runs, many times "
                               "slower", e)
                self._lib = None
        elif use_native:
            self._lib = load_cpu_ops()  # raises if unavailable
        else:
            self._lib = None
        #: OpenMP threads of the native Adam: torch's intra-op count,
        #: never more than the host's cores
        self.omp_threads = max(1, min(os.cpu_count() or 1,
                                      torch.get_num_threads()))
        self._state: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}

    @property
    def is_native(self) -> bool:
        return self._lib is not None

    def _moments(self, idx: int, leaf: torch.Tensor):
        if idx not in self._state:
            self._state[idx] = (torch.zeros_like(leaf),
                                torch.zeros_like(leaf))
        return self._state[idx]

    def _lr_now(self) -> float:
        if callable(self.lr):
            return float(self.lr(self.step_count))
        return float(self.lr)

    def apply_leaf(self, p, g, m, v, lr: float, kind: int,
                   out: Optional[torch.Tensor] = None) -> None:
        """ONE leaf's fused Adam on contiguous fp32 CPU tensors (updated
        in place; ``step_count`` already advanced by the caller), writing
        the updated parameter's low-precision copy into ``out`` (a
        2-byte tensor of ``p``'s size) when ``kind`` asks for one."""
        if self._lib is not None:
            f32, u16 = ctypes.c_float, ctypes.c_uint16
            self._lib.ds_cpu_adam_step(
                p.numel(), _ptr(p, f32), _ptr(g, f32), _ptr(m, f32),
                _ptr(v, f32), lr, self.betas[0], self.betas[1], self.eps,
                self.weight_decay, int(self.adamw_mode),
                int(self.bias_correction), self.step_count,
                _ptr(out, u16) if kind else None, kind)
        else:
            self._numpy_step(p.numpy(), g.numpy(), m.numpy(), v.numpy(),
                             lr)
            if kind:
                out.copy_(p.to(_LOWP_DTYPES[kind]).view(out.shape))

    def step_leaves(self, params, grads, out_dtype=None, leaf_get=None,
                    leaf_span=None, outs=None):
        """Per-leaf generator: yields ``(i, out_i)`` the moment leaf
        ``i``'s master and moments are written — the hook the streaming
        upload consumes while the loop goes on to leaf i+1.  ``leaf_get(i,
        g)`` turns grad ``i`` into a contiguous fp32 CPU tensor (default:
        ``g`` itself; the offload tier's pull waits on its D2H copy
        there); ``leaf_span(i)`` brackets leaf i's compute; ``outs[i]``
        receives leaf i's ``out_dtype`` copy (allocated when not given).
        Non-fp32 leaves pass through.  The step counter advances once."""
        if leaf_get is None:
            leaf_get = lambda i, g: g.float().contiguous()  # noqa: E731
        if self._lib is not None:
            self._lib.omp_set_num_threads(self.omp_threads)
        self.step_count += 1
        lr = self._lr_now()
        kind = lowp_kind(out_dtype)
        for i, (p, g) in enumerate(zip(params, grads)):
            if p.dtype != torch.float32:
                yield i, (p if kind else None)
                continue
            with (leaf_span(i) if leaf_span is not None
                  else contextlib.nullcontext()):
                assert p.is_contiguous(), (
                    f"leaf {i} is not contiguous: the update would land "
                    "in a copy")
                m, v = self._moments(i, p)
                out = None
                if kind:
                    out = (outs[i] if outs is not None else
                           torch.empty(p.shape, dtype=out_dtype))
                self.apply_leaf(p, leaf_get(i, g), m, v, lr, kind, out)
            yield i, out

    def _numpy_step(self, p, g, m, v, lr):
        b1, b2 = self.betas
        if not self.adamw_mode and self.weight_decay > 0:
            g = g + self.weight_decay * p
        m *= b1
        m += (1 - b1) * g
        v *= b2
        v += (1 - b2) * g * g
        c1 = c2 = 1.0
        if self.bias_correction:
            c1 = 1 - b1 ** self.step_count
            c2 = 1 - b2 ** self.step_count
        update = (m / c1) / (np.sqrt(v) / np.sqrt(c2) + self.eps)
        if self.adamw_mode and self.weight_decay > 0:
            update = update + self.weight_decay * p
        p -= lr * update
