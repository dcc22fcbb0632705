"""Port parity: both packages parse the serving config dicts of
tests/test_inference.py to equal values (and refuse the invalid ones with
the same message)."""
import pytest

from deepspeed_tpu.config import DeepSpeedConfig as JaxDeepSpeedConfig
from deepspeed_tpu.config.config import (
    DeepSpeedConfigError as JaxConfigError,
    DeepSpeedServingConfig as JaxServing,
    DeepSpeedStagesConfig as JaxStages,
    DeepSpeedTelemetryConfig as JaxTelemetry)
from deepspeed_tpu_torch.config import DeepSpeedConfig
from deepspeed_tpu_torch.config.config import (DeepSpeedConfigError,
                                               DeepSpeedServingConfig,
                                               DeepSpeedStagesConfig,
                                               DeepSpeedTelemetryConfig)

VALID = [
    {"serving": {"slots": 4, "max_seq_len": 32, "prefill_len": 8}},
    {"serving": {"slots": 3, "max_seq_len": 32, "prefill_len": 8},
     "telemetry": {"enabled": True, "output_path": "/tmp/serve_tel"}},
    {"serving": {"slots": 2, "max_seq_len": 16, "prefill_len": 8}},
    {"serving": {"slots": 1, "max_seq_len": 32, "prefill_len": 8}},
    {"serving": {"slots": 4, "max_seq_len": 32, "prefill_len": 4}},
    {"serving": {"slots": 2}},
    {"serving": {"slots": 8, "max_seq_len": 1024, "prefill_len": 512,
                 "eos_id": 50256, "decode_impl": "pallas"},
     "stages": {"max_stage_failures": 5}},
    {},
]
INVALID = [
    {"serving": {"slots": 0}},
    {"serving": {"max_seq_len": 8, "prefill_len": 16}},
    {"serving": {"decode_impl": "cuda"}},
    {"serving": {"eos_id": "</s>"}},
    {"serving": {"queue_capacity": True}},
]
BLOCKS = [(JaxServing, DeepSpeedServingConfig),
          (JaxTelemetry, DeepSpeedTelemetryConfig),
          (JaxStages, DeepSpeedStagesConfig)]


@pytest.mark.parametrize("cfg", VALID)
def test_serving_blocks_parse_equal(cfg):
    for jax_cls, port_cls in BLOCKS:
        assert vars(port_cls(cfg)) == vars(jax_cls(cfg)), port_cls.__name__


@pytest.mark.parametrize("cfg", INVALID)
def test_invalid_serving_blocks_refused_alike(cfg):
    with pytest.raises(JaxConfigError) as ref:
        JaxServing(cfg)
    with pytest.raises(DeepSpeedConfigError) as ours:
        DeepSpeedServingConfig(cfg)
    assert str(ours.value) == str(ref.value)


def test_full_config_serving_block_parses_equal():
    src = {"train_batch_size": 8, "serving": {"slots": 16}}
    ours = DeepSpeedConfig(src, world_size=8)
    ref = JaxDeepSpeedConfig(src, world_size=8)
    assert ours.serving_config.slots == 16
    assert vars(ours.serving_config) == vars(ref.serving_config)


def _ref_first_loss_dict(total_batch):
    """The training dict ``__graft_entry__._ref_first_loss`` builds."""
    return {"train_micro_batch_size_per_gpu": 1,
            "gradient_accumulation_steps": total_batch,
            "steps_per_print": 10 ** 9,
            "bf16": {"enabled": True},
            "zero_optimization": {"stage": 0},
            "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}


TRAIN = [
    _ref_first_loss_dict(4),
    _ref_first_loss_dict(8),
    {"train_batch_size": 16, "train_micro_batch_size_per_gpu": 8,
     "gradient_clipping": 1.0, "fp16": {"enabled": True,
                                        "initial_scale_power": 8,
                                        "hysteresis": 1},
     "optimizer": {"type": "Adam", "params": {"lr": 1e-4,
                                              "betas": [0.9, 0.95]}},
     "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 8}}},
]


@pytest.mark.parametrize("cfg", TRAIN)
def test_training_dicts_parse_equal(cfg):
    ours, ref = DeepSpeedConfig(cfg, world_size=1), \
        JaxDeepSpeedConfig(cfg, world_size=1)
    for name in ("train_batch_size", "train_micro_batch_size_per_gpu",
                 "gradient_accumulation_steps", "steps_per_print",
                 "gradient_clipping", "optimizer_name", "optimizer_params",
                 "scheduler_name", "scheduler_params", "fp16_enabled",
                 "bf16_enabled", "zero_optimization_stage"):
        assert getattr(ours, name) == getattr(ref, name), name
    assert vars(ours.fp16) == vars(ref.fp16)
    assert vars(ours.zero_config) == vars(ref.zero_config)
