"""Data, tensor, pipeline and sequence parallelism on
``torch.distributed`` — the counterpart of ``deepspeed_tpu/parallel/``
(``partition.py`` is a copy of the JAX module; ``sequence.py`` holds ring
and Ulysses attention over the ``seq`` axis)."""
from .topology import (  # noqa: F401
    ProcessTopology,
    PipeDataParallelTopology,
    PipeModelDataParallelTopology,
    ParallelGrid,
)
from .mesh import (  # noqa: F401
    Mesh,
    RankSharding,
    build_mesh,
    single_device_mesh,
    mesh_axis_size,
    PIPE_AXIS,
    DATA_AXIS,
    SEQ_AXIS,
    MODEL_AXIS,
    DEFAULT_AXES,
)
from .distributed import init_distributed, is_initialized  # noqa: F401
from . import collectives  # noqa: F401
from .sequence import ring_attention, ulysses_attention  # noqa: F401
