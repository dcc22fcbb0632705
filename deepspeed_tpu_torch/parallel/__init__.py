"""Data and tensor parallelism on ``torch.distributed`` — the counterpart
of ``deepspeed_tpu/parallel/`` (its ``partition.py`` and ``sequence.py``
are ROADMAP.md queue 1 items 10 and 11)."""
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
