"""Compressed data-parallel communication — the port of
``deepspeed_tpu/compress``: 1-bit Adam's sign-compressed momentum
exchange over ``torch.distributed``."""
from .onebit import (OnebitAdamState, compressed_allreduce,
                     init_onebit_state, onebit_adam, pack_signs,
                     padded_size, simulated_compressed_allreduce,
                     unpack_signs)

__all__ = [
    "OnebitAdamState", "compressed_allreduce", "init_onebit_state",
    "onebit_adam", "pack_signs", "padded_size",
    "simulated_compressed_allreduce", "unpack_signs",
]
