"""deepspeed_tpu_torch — the PyTorch + CUDA port of ``deepspeed_tpu``.

A second package beside the JAX one, built for one NVIDIA H100.  It keeps
the JAX package's module layout, ``ds_config.json`` keys and GPT-2
parameter tree, and it never imports ``jax`` or ``deepspeed_tpu``: what
it needs from the JAX package's pure-Python modules it carries as its own
copy.  Every Pallas kernel on a ported path becomes a kernel written by
hand for Hopper (``csrc/``), built on first use by
``ops/kernels/build.py``.

Ported so far: GPT-2 greedy serving (``inference.ServeEngine``) on the
slot cache and the paged pool, with greedy speculation; training
(``initialize`` → ``DeepSpeedEngine.train_batch``), data- and
tensor-parallel over ``torch.distributed`` with ZeRO stages 0–3
(``parallel``, ``runtime.zero``), of GPT-2 and of BERT (``models.bert``: MLM + NSP, the ``DeepSpeedTransformerLayer``
encoder, Adam or LAMB, progressive layer drop), with checkpoints in the
JAX package's on-disk format (``runtime.checkpointing``: async and
SIGTERM saves, CRC-verified loads with a fallback chain); KV tiering of
idle serving sessions (``inference.kv_tier``); and block-sparse attention
(``ops.sparse_attention``: ``SparseSelfAttention``,
``BertSparseSelfAttention``); and pipeline parallelism (``pipe``:
``PipelineModule`` of ``LayerSpec``s, the 1F1B and GPipe schedules over
``torch.distributed`` point-to-point, GPT-2 and BERT as pipeline modules
in ``models.gpt2_pipe`` and ``models.bert_pipe``); sequence and expert
parallelism (``parallel.sequence``, ``moe``), composed (GPT-2 MoE on a
``seq`` axis); compressed data parallelism (``compress``: 1-bit Adam's
sign-compressed momentum exchange; ``runtime.csr_tensor``: CSR embedding
gradients); the standalone block-sparse ``MatMul``/``Softmax`` ops and
activation checkpointing (``checkpointing``).  Kernels:
flash attention forward and
backward, the four decode-attention kernels and the block-sparse forward,
dQ and dK/dV.  ROADMAP.md lists what comes next.

    engine, optimizer, dataloader, lr_schedule = deepspeed_tpu_torch.initialize(
        model=BertModel(BERT_LARGE), config=ds_config)
    loss = engine.train_batch(batch)

A launched script (``bin/ds_torch``, one process a card; ``launcher/``)
calls ``add_config_arguments(parser)``, ``init_distributed()`` and
``initialize(args=...)``.  The JAX package's top-level names resolve
here lazily (``FlaxModule`` has no PyTorch counterpart): importing the
package loads no torch, so the launcher's processes never do.
"""
from __future__ import annotations

import argparse
import importlib

from .version import __version__  # noqa: F401

#: the top-level names, resolved on first access: name -> (submodule, attr)
_LAZY = {
    "ADAM_OPTIMIZER": ("config.constants", "ADAM_OPTIMIZER"),
    "LAMB_OPTIMIZER": ("config.constants", "LAMB_OPTIMIZER"),
    "DeepSpeedConfig": ("config", "DeepSpeedConfig"),
    "DeepSpeedConfigError": ("config.config", "DeepSpeedConfigError"),
    "init_distributed": ("parallel.distributed", "init_distributed"),
    "DeepSpeedEngine": ("runtime.engine", "DeepSpeedEngine"),
    "TrainModule": ("runtime.module", "TrainModule"),
    "FunctionalModule": ("runtime.module", "FunctionalModule"),
    "DeepSpeedDataLoader": ("runtime.dataloader", "DeepSpeedDataLoader"),
    "RepeatingLoader": ("runtime.dataloader", "RepeatingLoader"),
    "DevicePlacedBatch": ("runtime.prefetch", "DevicePlacedBatch"),
    "DevicePrefetcher": ("runtime.prefetch", "DevicePrefetcher"),
    "add_tuning_arguments": ("runtime.lr_schedules", "add_tuning_arguments"),
    "checkpointing": ("runtime.activation_checkpointing", "checkpointing"),
    "log_dist": ("utils.logging", "log_dist"),
    "DeepSpeedTransformerLayer": ("ops.transformer",
                                  "DeepSpeedTransformerLayer"),
    "DeepSpeedTransformerConfig": ("ops.transformer",
                                   "DeepSpeedTransformerConfig"),
    "PipelineModule": ("pipe.module", "PipelineModule"),
    "PipelineEngine": ("pipe.engine", "PipelineEngine"),
    "__git_hash__": ("git_version_info", "git_hash"),
    "__git_branch__": ("git_version_info", "git_branch"),
}

__all__ = ["initialize", "add_config_arguments", "__version__",
           *(n for n in _LAZY if not n.startswith("__"))]


def __getattr__(name):
    try:
        module, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    value = getattr(importlib.import_module(f".{module}", __name__), attr)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))


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
    on ``cuda:LOCAL_RANK`` unless ``device`` names another; with no CUDA
    device and no ``device`` it raises.

    Data and tensor parallelism: the process joins the job's
    ``torch.distributed`` group from the env contract (``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``;
    ``parallel.init_distributed``) and trains on ``mesh`` (a
    ``parallel.build_mesh(dp=..., tp=...)``; by default every rank on the
    data axis, or one local rank when no group was joined).  The config's
    ``world_size`` is the mesh's data axis, so ``train_batch_size`` is
    ``micro × grad_acc × dp`` and each rank feeds its own
    ``micro × grad_acc`` rows.

    A ``pipe.PipelineModule`` dispatches to ``pipe.PipelineEngine``
    (``pipeline.schedule`` picks its schedule): by default the mesh is
    ``build_mesh(pp=model.num_stages)``, each pipe rank runs its stage,
    and every rank is given the whole ``(inputs, labels)`` batch."""
    from .config import DeepSpeedConfig
    from .config.config import DeepSpeedConfigError
    from .parallel.distributed import init_distributed, is_initialized
    from .parallel.mesh import DATA_AXIS, build_mesh, mesh_axis_size
    from .runtime.engine import DeepSpeedEngine, check_mesh, refuse_unported

    assert model is not None, "deepspeed_tpu_torch.initialize requires a model"
    cfg_src = config if config is not None else config_params
    if cfg_src is None and args is not None:
        cfg_src = getattr(args, "deepspeed_config", None)
    if cfg_src is None:
        raise DeepSpeedConfigError("No DeepSpeed config provided")
    from .pipe.module import PipelineModule
    check_mesh(mesh)
    init_distributed(device=device)
    pipelined = isinstance(model, PipelineModule)
    if mesh is None and is_initialized():
        mesh = build_mesh(pp=model.num_stages if pipelined else 1)
    dp = mesh_axis_size(mesh, DATA_AXIS) if mesh is not None else 1
    cfg = (cfg_src if isinstance(cfg_src, DeepSpeedConfig)
           else DeepSpeedConfig(cfg_src, world_size=dp))
    refuse_unported(cfg, optimizer, mesh)
    if pipelined:
        from .pipe.engine import PipelineEngine
        engine = PipelineEngine(
            model=model, config=cfg, mesh=mesh, optimizer=optimizer,
            lr_schedule=lr_scheduler, params=params,
            training_data=training_data, collate_fn=collate_fn, seed=seed,
            device=device)
        return (engine, engine.optimizer, engine.training_dataloader,
                engine.lr_scheduler)
    engine = DeepSpeedEngine(model=model, config=cfg, optimizer=optimizer,
                             lr_schedule=lr_scheduler, params=params,
                             training_data=training_data,
                             collate_fn=collate_fn, seed=seed, device=device,
                             mesh=mesh)
    return (engine, engine.optimizer, engine.training_dataloader,
            engine.lr_scheduler)


def add_config_arguments(parser: argparse.ArgumentParser):
    """argparse plumbing (reference: deepspeed/__init__.py:139-203; a
    copy of the JAX package's)."""
    group = parser.add_argument_group("DeepSpeed", "DeepSpeed configurations")
    group.add_argument("--deepspeed", default=False, action="store_true",
                       help="Enable DeepSpeed (helper flag, parity only)")
    group.add_argument("--deepspeed_config", default=None, type=str,
                       help="Path to the DeepSpeed json config file")
    group.add_argument("--deepscale", default=False, action="store_true",
                       help=argparse.SUPPRESS)  # deprecated alias
    group.add_argument("--deepscale_config", default=None, type=str,
                       help=argparse.SUPPRESS)
    return parser
