"""Per-node launcher — the port of ``deepspeed_tpu/launcher/launch.py``.

Decodes the world info and forks ONE PROCESS PER SLOT of this host, as
upstream DeepSpeed's launch.py does (the JAX package execs one process a
host instead).  Each child gets the ``torch.distributed`` env contract
``parallel/distributed.py`` reads:

  MASTER_ADDR, MASTER_PORT   the rendezvous (rank 0's host)
  RANK                       the slots of the hosts before this one,
                             plus LOCAL_RANK
  LOCAL_RANK                 the child's index among this host's slots
  WORLD_SIZE                 every host's slots, summed
  CUDA_VISIBLE_DEVICES       this host's slot list, so ``cuda:LOCAL_RANK``
                             is the physical card ``slots[LOCAL_RANK]``

The launcher stays the children's parent: it forwards SIGTERM and SIGINT
to every child (a ``checkpoint.sigterm_save`` hook still gets its
step-boundary save); when a child exits non-zero it SIGTERMs the others,
waits ``TERM_GRACE_S`` seconds, SIGKILLs what is left and exits with that
child's code; each child dies with it (``PR_SET_PDEATHSIG``), so
a launcher SIGKILLed by the elastic supervisor leaves no rank holding a
card or ``MASTER_PORT``.  It returns only once every child is reaped.

Like the runner, this module imports no torch; the teardown is the
elastic supervisor's own (``supervise.terminate_with_grace``).
"""
from __future__ import annotations

import argparse
import base64
import ctypes
import json
import os
import signal
import subprocess
import sys
import time
from typing import List, Optional

from ..utils.logging import logger
from .supervise import terminate_with_grace

#: seconds between the SIGTERM to the surviving ranks and their SIGKILL
#: after one rank failed (the elastic supervisor's own grace)
TERM_GRACE_S = 10.0
_POLL_S = 0.05
_PR_SET_PDEATHSIG = 1


def parse_args(args=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--world_info", type=str, required=True,
                        help="base64 json of {host: [slots]}")
    parser.add_argument("--node_rank", type=int, required=True)
    parser.add_argument("--master_addr", type=str, required=True)
    parser.add_argument("--master_port", type=int, default=29500)
    parser.add_argument("user_script", type=str)
    parser.add_argument("user_args", nargs=argparse.REMAINDER)
    return parser.parse_args(args=args)


def decode_world_info(encoded: str) -> dict:
    return json.loads(base64.urlsafe_b64decode(encoded.encode()).decode())


# env vars the MPI launchers leave behind, in resolution order
_MPI_RANK_VARS = ("OMPI_COMM_WORLD_RANK", "MV2_COMM_WORLD_RANK",
                  "PMI_RANK")


def resolve_node_rank(node_rank: int, env=None) -> int:
    """``--node_rank=-1`` means "ask the MPI environment": the openmpi /
    mvapich runners broadcast ONE identical command to every node
    (launcher/multinode_runner.py), so the per-node rank can only come
    from the transport's own rank variable."""
    if node_rank >= 0:
        return node_rank
    env = os.environ if env is None else env
    for var in _MPI_RANK_VARS:
        if var in env:
            return int(env[var])
    raise ValueError(
        "--node_rank=-1 requires an MPI rank variable in the "
        f"environment (one of {', '.join(_MPI_RANK_VARS)}); launch "
        "through mpirun or pass an explicit --node_rank")


def build_env(world_info: dict, node_rank: int, master_addr: str,
              master_port: int, base_env=None, local_rank: int = 0) -> dict:
    """The env of this host's ``local_rank``-th process (module
    docstring)."""
    env = dict(base_env if base_env is not None else os.environ)
    hosts = list(world_info.keys())
    if not 0 <= node_rank < len(hosts):
        raise ValueError(
            f"node_rank {node_rank} out of range for {len(hosts)} hosts")
    slots = world_info[hosts[node_rank]]
    if not 0 <= local_rank < len(slots):
        raise ValueError(
            f"local_rank {local_rank} out of range for host "
            f"{hosts[node_rank]!r}'s {len(slots)} slot(s)")
    before = sum(len(world_info[h]) for h in hosts[:node_rank])
    env.update({
        "MASTER_ADDR": master_addr,
        "MASTER_PORT": str(master_port),
        "RANK": str(before + local_rank),
        "LOCAL_RANK": str(local_rank),
        "WORLD_SIZE": str(sum(len(s) for s in world_info.values())),
        "CUDA_VISIBLE_DEVICES": ",".join(str(s) for s in slots),
    })
    return env


def _die_with_parent(parent: int):
    """A ``preexec_fn``: the child gets SIGKILL when the launcher dies
    (``prctl(PR_SET_PDEATHSIG)``; Linux), and exits at once if the
    launcher already died between the fork and this call."""
    def arm():
        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(_PR_SET_PDEATHSIG, signal.SIGKILL, 0, 0, 0)
        if os.getppid() != parent:
            os._exit(1)
    return arm


def _exit_code(rc: int) -> int:
    """A child's ``returncode`` as an exit status: a signal N (rc -N)
    becomes 128 + N, as a shell reports it."""
    return 128 - rc if rc < 0 else rc


def supervise(procs: List[subprocess.Popen]) -> int:
    """Wait for this host's ranks: 0 once all exit 0; the first
    non-zero exit's code after the others are torn down."""
    while True:
        failed: Optional[subprocess.Popen] = None
        live = 0
        for p in procs:
            rc = p.poll()
            if rc is None:
                live += 1
            elif rc != 0 and failed is None:
                failed = p
        if failed is not None:
            logger.warning("launch: rank process %d exited %d; stopping "
                           "the other %d", failed.pid, failed.returncode,
                           live)
            terminate_with_grace([(str(p.pid), p) for p in procs],
                                 TERM_GRACE_S)
            return _exit_code(failed.returncode)
        if live == 0:
            return 0
        time.sleep(_POLL_S)


def main(args=None):
    args = parse_args(args)
    world_info = decode_world_info(args.world_info)
    node_rank = resolve_node_rank(args.node_rank)
    hosts = list(world_info)
    if not 0 <= node_rank < len(hosts):
        raise ValueError(
            f"node_rank {node_rank} out of range for {len(hosts)} hosts")
    cmd = [sys.executable, args.user_script] + args.user_args
    procs: List[subprocess.Popen] = []

    def forward(signum, _frame):
        for p in procs:
            if p.poll() is None:
                p.send_signal(signum)

    signal.signal(signal.SIGTERM, forward)
    signal.signal(signal.SIGINT, forward)
    try:
        for local_rank in range(len(world_info[hosts[node_rank]])):
            env = build_env(world_info, node_rank, args.master_addr,
                            args.master_port, local_rank=local_rank)
            logger.info("node %d/%d rank %s (local %d): %s", node_rank,
                        len(hosts), env["RANK"], local_rank, " ".join(cmd))
            procs.append(subprocess.Popen(
                cmd, env=env, preexec_fn=_die_with_parent(os.getpid())))
        rc = supervise(procs)
    finally:
        # a launch that failed part-way (or was interrupted) reaps what
        # it started before it returns
        terminate_with_grace([(str(p.pid), p) for p in procs], TERM_GRACE_S)
    sys.exit(rc)


if __name__ == "__main__":
    main()
