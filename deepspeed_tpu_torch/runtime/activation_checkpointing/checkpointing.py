"""Activation checkpointing — the port of
``deepspeed_tpu/runtime/activation_checkpointing/checkpointing.py``.

The reference's Megatron-derived autograd function saves the RNG state,
optionally partitions or offloads the saved activations, and recomputes
in the backward.  Here each piece is a PyTorch facility:

  checkpoint(fn, *args)      → ``torch.utils.checkpoint.checkpoint(...,
                               use_reentrant=False)``: the region keeps
                               its inputs and recomputes the rest in the
                               backward, the RNG state replayed.
  partition_activations      → accepted and recorded: the training
                               engine keeps each rank's activations its
                               own (data rows, seq shard, tensor-parallel
                               heads); nothing to partition by hand.
  cpu_checkpointing          → the region runs once and every tensor its
                               backward saves is kept in host memory
                               (pinned, for a CUDA tensor) and copied back
                               when the backward asks for it — a
                               ``saved_tensors_hooks`` pair, the
                               counterpart of the JAX module's policy that
                               offloads saved dot operands to pinned host
                               memory.  Never a silent fall back to full
                               recompute.  ``offload_stats`` counts what
                               the hooks moved.
  RNGStatesTracker           → named streams of host-integer seeds: fork()
                               returns a fresh seed (``fold_in``) and
                               advances the stream.

``configure()`` / ``is_configured()`` / ``reset()`` mirror the reference
module surface.
"""
from __future__ import annotations

import collections
from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint as _torch_checkpoint

from ...config.config import DeepSpeedActivationCheckpointingConfig
from ..utils import fold_in

_config: Optional[DeepSpeedActivationCheckpointingConfig] = None

#: what the cpu_checkpointing hooks kept in host memory in this process:
#: ``tensors`` and ``bytes`` packed, ``restored`` unpacked by a backward
offload_stats: collections.Counter = collections.Counter()


# ---------------------------------------------------------------------------
# RNG tracker (reference CudaRNGStatesTracker)
# ---------------------------------------------------------------------------
_MODEL_PARALLEL_RNG = "model-parallel-rng"


class RNGStatesTracker:
    """Named streams of host-integer seeds.  ``add(name, seed)`` registers
    a stream; ``fork(name)`` returns a fresh seed and advances the stream
    — the port's counterpart of the reference's get/set of the device RNG
    state around each checkpointed region (the port's dropouts draw from
    generators built from such seeds, ``runtime/utils.py``)."""

    def __init__(self):
        self.states_: Dict[str, int] = {}

    def reset(self):
        self.states_ = {}

    def get_states(self) -> Dict[str, int]:
        return dict(self.states_)

    def set_states(self, states: Dict[str, int]):
        self.states_ = dict(states)

    def add(self, name: str, seed: int):
        if name in self.states_:
            raise Exception(f"rng state {name} already exists")
        self.states_[name] = int(seed)

    def fork(self, name: str = _MODEL_PARALLEL_RNG) -> int:
        if name not in self.states_:
            raise Exception(f"rng state {name} is not added")
        state = self.states_[name]
        self.states_[name] = fold_in(state, 0)
        return fold_in(state, 1)


_RNG_TRACKER = RNGStatesTracker()


def get_cuda_rng_tracker() -> RNGStatesTracker:  # reference-compatible name
    return _RNG_TRACKER


def model_parallel_cuda_manual_seed(seed: int, tp_rank: int = 0,
                                    pp_rank: int = 0, tp_size: int = 1):
    """The reference's seed scheme: the model-parallel stream offsets by
    2718 + tp_rank (+ the pipeline offset), so tensor-parallel ranks draw
    different dropout masks while the default stream stays the same on
    every rank.  Returns the stream's seed."""
    offset = seed + 2718 + pp_rank * tp_size
    _RNG_TRACKER.reset()
    _RNG_TRACKER.add(_MODEL_PARALLEL_RNG, offset + tp_rank)
    return offset + tp_rank


# ---------------------------------------------------------------------------
# the host-memory hooks of cpu_checkpointing
# ---------------------------------------------------------------------------
def _pack(t: torch.Tensor):
    offload_stats["tensors"] += 1
    offload_stats["bytes"] += t.numel() * t.element_size()
    if t.device.type == "cpu":
        return t.device, t
    host = torch.empty(t.size(), dtype=t.dtype, layout=t.layout,
                       pin_memory=True)
    host.copy_(t, non_blocking=True)
    return t.device, host


def _unpack(packed) -> torch.Tensor:
    device, host = packed
    offload_stats["restored"] += 1
    return host.to(device, non_blocking=True)


# ---------------------------------------------------------------------------
# configure() and checkpoint()
# ---------------------------------------------------------------------------
def configure(mpu_=None, deepspeed_config=None,
              partition_activations: Optional[bool] = None,
              contiguous_checkpointing: Optional[bool] = None,
              num_checkpoints: Optional[int] = None,
              checkpoint_in_cpu: Optional[bool] = None,
              synchronize: Optional[bool] = None,
              profile: Optional[bool] = None):
    """The reference's configure: the config block (a ``DeepSpeedConfig``
    or a ds_config dict), then the explicit arguments over it."""
    global _config
    if deepspeed_config is not None and hasattr(
            deepspeed_config, "activation_checkpointing_config"):
        _config = deepspeed_config.activation_checkpointing_config
    elif isinstance(deepspeed_config, dict):
        _config = DeepSpeedActivationCheckpointingConfig(deepspeed_config)
    elif _config is None:
        _config = DeepSpeedActivationCheckpointingConfig({})
    for name, val in (("partition_activations", partition_activations),
                      ("contiguous_memory_optimization",
                       contiguous_checkpointing),
                      ("number_checkpoints", num_checkpoints),
                      ("cpu_checkpointing", checkpoint_in_cpu),
                      ("synchronize_checkpoint_boundary", synchronize),
                      ("profile", profile)):
        if val is not None:
            setattr(_config, name, val)


def is_configured() -> bool:
    return _config is not None


def reset():
    """The reference's reset(): clears what configure() set."""
    global _config
    _config = None


def checkpoint(function, *args):
    """Checkpoint a forward segment (the reference's
    ``CheckpointFunction.apply``): recomputed in the backward, or under
    ``cpu_checkpointing`` run once with what its backward saves kept in
    host memory."""
    if is_configured() and _config.cpu_checkpointing:
        with torch.autograd.graph.saved_tensors_hooks(_pack, _unpack):
            return function(*args)
    return _torch_checkpoint(function, *args, use_reentrant=False)
