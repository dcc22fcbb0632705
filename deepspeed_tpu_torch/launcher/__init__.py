"""Launcher — hostfile-driven job dispatch with one process per card
(reference feature slot: deepspeed/launcher/ + bin/ds; the port of
``deepspeed_tpu/launcher/``): ``runner`` (the ``ds_torch`` CLI),
``launch`` (the per-node launcher that forks a host's ranks),
``multinode_runner`` (pdsh/ssh/OpenMPI/MVAPICH), ``elastic`` (the
``--elastic`` restart loop) and ``supervise`` (the helpers the elastic
agent shares with the serving fleet's router).  Nothing here imports
torch.  The names below resolve on first access, so ``python -m
deepspeed_tpu_torch.launcher.launch`` runs a module the package has not
imported already."""
import importlib

_EXPORTS = {"encode_world_info": "runner", "fetch_hostfile": "runner",
            "parse_inclusion_exclusion": "runner",
            "parse_resource_filter": "runner", "build_env": "launch",
            "decode_world_info": "launch"}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__),
                   name)
