"""Joining the job's process group — the counterpart of
``deepspeed_tpu/parallel/distributed.py``.

The JAX package joins ``jax.distributed`` from its launcher's env; the
port joins ``torch.distributed`` from the env contract every torch
launcher exports (``torchrun``, and the port's own ``ds_torch``, whose
per-node launcher ``launcher/launch.py`` forks one process a card):

  MASTER_ADDR, MASTER_PORT   the rendezvous (rank 0's host and a free port)
  RANK, WORLD_SIZE           this process's rank and the job's size
  LOCAL_RANK                 this process's card on its host

Explicit arguments override the env.  The backend follows the device the
engine trains on: ``nccl`` for ``cuda`` (by default ``cuda:LOCAL_RANK``;
without a CUDA device that raises unless ``device="cpu"`` is given, as the
engine's ``resolve_device`` does), ``gloo`` for ``cpu``.  A timeout
is always passed, so a rank that dies leaves the others raising instead
of waiting forever.  ``deepspeed_tpu_torch.initialize()`` calls
:func:`init_distributed`; without the env (and without arguments) it is a
no-op and the engine runs as one process with no process group.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..utils.logging import log_dist

#: the process group's collective timeout unless the caller passes one
DEFAULT_TIMEOUT_S = 600.0


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def local_rank() -> int:
    """This process's card on its host (``LOCAL_RANK``, 0 without it)."""
    return int(os.environ.get("LOCAL_RANK", "0") or 0)


def init_distributed(device=None,
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the job's process group if the env contract (or the
    arguments) describe one.  Returns True iff this call created the
    group.  Idempotent: a group that exists already (the caller's own,
    or an earlier call's) is kept.

    ``device``: the device the engine will train on — it picks the
    backend.  Default ``cuda:LOCAL_RANK``; with no CUDA device a group is
    never joined on the CPU by default: pass ``device="cpu"`` (gloo).
    ``init_method``: a ``tcp://host:port`` or ``file://path`` URL; default
    ``env://`` when ``MASTER_ADDR`` is set."""
    if is_initialized():
        return False
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "0") or 0)
    if rank is None:
        rank = int(os.environ.get("RANK", "0") or 0)
    if init_method is None:
        if not os.environ.get("MASTER_ADDR") or world_size < 1:
            return False
        init_method = "env://"
    if world_size < 1:
        raise ValueError("init_distributed: world_size must be >= 1 (pass "
                         "it or export WORLD_SIZE)")
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"init_distributed: device {device} needs CUDA, "
            "which is not available; pass device='cpu' to join the group "
            "on the CPU (gloo)")
    backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl":
        if device.index is None:
            device = torch.device("cuda", local_rank())
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend=backend, init_method=init_method, rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=float(timeout_s)))
    log_dist(f"torch.distributed initialized: rank {rank}/{world_size} "
             f"backend={backend} init={init_method}", ranks=[0])
    return True
