from . import checkpointing
from ...config.config import DeepSpeedActivationCheckpointingConfig
