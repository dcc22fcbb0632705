"""deepspeed_tpu_torch — the PyTorch + CUDA port of ``deepspeed_tpu``.

A second package beside the JAX one, built for one NVIDIA H100.  It keeps
the JAX package's module layout, ``ds_config.json`` keys and GPT-2
parameter tree, and it never imports ``jax`` or ``deepspeed_tpu``: what
it needs from the JAX package's pure-Python modules it carries as its own
copy.  Every Pallas kernel on a ported path becomes a kernel written by
hand for Hopper (``csrc/``), built on first use by
``ops/kernels/build.py``.

Ported so far: GPT-2 greedy serving (``inference.ServeEngine``) on the
slot cache and the paged pool, with greedy speculation; single-device
training (``initialize`` → ``DeepSpeedEngine.train_batch``) of GPT-2 and
of BERT (``models.bert``: MLM + NSP, the ``DeepSpeedTransformerLayer``
encoder, Adam or LAMB, progressive layer drop); and block-sparse attention
(``ops.sparse_attention``: ``SparseSelfAttention``,
``BertSparseSelfAttention``).  Kernels: flash attention forward and
backward, the four decode-attention kernels and the block-sparse forward,
dQ and dK/dV.  ROADMAP.md lists what comes next.

    engine, optimizer, dataloader, lr_schedule = deepspeed_tpu_torch.initialize(
        model=BertModel(BERT_LARGE), config=ds_config)
    loss = engine.train_batch(batch)
"""
from __future__ import annotations

from .config.constants import ADAM_OPTIMIZER, LAMB_OPTIMIZER  # noqa: F401
from .ops.transformer import (DeepSpeedTransformerConfig,  # noqa: F401
                              DeepSpeedTransformerLayer)
from .version import __version__  # noqa: F401


def initialize(args=None,
               model=None,
               optimizer=None,
               params=None,
               training_data=None,
               lr_scheduler=None,
               mesh=None,
               collate_fn=None,
               config=None,
               config_params=None,
               seed: int = 0,
               device=None):
    """Create the engine (the JAX package's ``initialize``).

    Returns ``(engine, optimizer, training_dataloader, lr_scheduler)``.
    ``config`` may be a ds_config.json path, a dict or a
    ``DeepSpeedConfig`` (``config_params`` is an alias).  The engine runs
    on ``cuda:0`` unless ``device`` names another; with no CUDA device
    and no ``device`` it raises.  ``mesh`` (data/tensor parallel) is not
    ported and raises."""
    from .config import DeepSpeedConfig
    from .config.config import DeepSpeedConfigError
    from .runtime.engine import DeepSpeedEngine, refuse_unported

    assert model is not None, "deepspeed_tpu_torch.initialize requires a model"
    cfg_src = config if config is not None else config_params
    if cfg_src is None and args is not None:
        cfg_src = getattr(args, "deepspeed_config", None)
    if cfg_src is None:
        raise DeepSpeedConfigError("No DeepSpeed config provided")
    cfg = (cfg_src if isinstance(cfg_src, DeepSpeedConfig)
           else DeepSpeedConfig(cfg_src, world_size=1))
    refuse_unported(cfg, optimizer, mesh)
    engine = DeepSpeedEngine(model=model, config=cfg, optimizer=optimizer,
                             lr_schedule=lr_scheduler, params=params,
                             training_data=training_data,
                             collate_fn=collate_fn, seed=seed, device=device)
    return (engine, engine.optimizer, engine.training_dataloader,
            engine.lr_scheduler)
