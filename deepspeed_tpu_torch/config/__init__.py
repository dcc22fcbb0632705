from .config import (
    DeepSpeedConfig,
    DeepSpeedConfigError,
    DeepSpeedZeroConfig,
    DeepSpeedFP16Config,
    DeepSpeedBF16Config,
    DeepSpeedActivationCheckpointingConfig,
    DeepSpeedSparseAttentionConfig,
    DeepSpeedServingConfig,
    DeepSpeedFleetConfig,
    DeepSpeedPipelineConfig,
    DeepSpeedConfigWriter,
)
from . import constants
