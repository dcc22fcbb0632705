"""Mixture-of-Experts with expert parallelism over ``data`` — the port of
``deepspeed_tpu/moe/``."""
from .layer import (MoEConfig, init_moe_params, moe_param_specs,  # noqa: F401
                    moe_ffn)

__all__ = ["MoEConfig", "init_moe_params", "moe_param_specs", "moe_ffn"]
