"""Pipeline parallelism — the port of ``deepspeed_tpu/pipe/``."""
from .module import LayerSpec, TiedLayerSpec, PipelineModule  # noqa: F401
