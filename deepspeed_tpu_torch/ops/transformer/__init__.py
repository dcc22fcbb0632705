"""The fused transformer layer's port (``deepspeed_tpu.ops.transformer``)."""
from .transformer import (DeepSpeedTransformerConfig,
                          DeepSpeedTransformerLayer)

__all__ = ["DeepSpeedTransformerConfig", "DeepSpeedTransformerLayer"]
