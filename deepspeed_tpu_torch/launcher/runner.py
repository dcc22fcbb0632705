"""``ds_torch`` CLI front-end — the port of
``deepspeed_tpu/launcher/runner.py``.

The resource model is the JAX package's (and the reference's,
deepspeed/launcher/runner.py:115-232): hostfile ``host slots=N`` lines,
``--include``/``--exclude`` NODE_SPEC[@NODE_SPEC...] filters, base64 world
info.  The launch semantics are upstream DeepSpeed's: ONE PROCESS PER
CARD.  Each host runs the per-node launcher (``launcher/launch.py``),
which forks one process per slot with the ``torch.distributed`` env
contract (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``LOCAL_RANK``,
``WORLD_SIZE``, ``CUDA_VISIBLE_DEVICES``).  Without a hostfile the pool is
``{"localhost": N}``: N is ``--num_gpus``, else the cards ``nvidia-smi -L``
lists; an inherited ``CUDA_VISIBLE_DEVICES`` (a scheduler's grant) limits
it to those cards, as upstream DeepSpeed's runner does.  Multi-node dispatch shells out over ssh (pdsh if present) or one
``mpirun`` (``launcher/multinode_runner.py``).

This module imports no torch: the launcher and the elastic supervisor
must keep running when the worker runtime is what broke.
"""
from __future__ import annotations

import argparse
import base64
import collections
import json
import os
import re
import shlex
import subprocess
import sys
from copy import deepcopy
from typing import Dict, List, Optional

from ..utils.logging import logger

DLTS_HOSTFILE = "/job/hostfile"
# DS_: the runtime's own knob/fault-injection family (DS_PREFETCH,
# DS_CKPT_*, DS_HEARTBEAT_DIR, ...) — an operator's escape hatch must
# reach every node, not just the launch host
EXPORT_ENVS = ("CUDA_", "NCCL_", "TORCH_", "OMP_", "PYTHON", "PATH",
               "LD_LIBRARY_PATH", "DEEPSPEED_TPU_", "DS_")
DEEPSPEED_ENVIRONMENT_NAME = ".deepspeed_env"
#: seconds ``nvidia-smi -L`` may take before the card count is refused
NVIDIA_SMI_TIMEOUT_S = 30


def parse_args(args=None):
    parser = argparse.ArgumentParser(
        description="deepspeed_tpu_torch launcher: run a training script "
        "with one process per card, across hosts")
    parser.add_argument("-H", "--hostfile", type=str, default=DLTS_HOSTFILE,
                        help="hostfile of 'hostname slots=N' lines "
                        "(slots = cards on that host)")
    parser.add_argument("-i", "--include", type=str, default="",
                        help="NODE_SPEC[@NODE_SPEC ...]; "
                        "NODE_SPEC=NAME[:SLOT[,SLOT...]]")
    parser.add_argument("-e", "--exclude", type=str, default="",
                        help="same syntax as --include; mutually exclusive")
    parser.add_argument("--num_nodes", type=int, default=-1,
                        help="limit to the first N nodes of the hostfile")
    parser.add_argument("--num_gpus", "--num_chips", type=int, default=-1,
                        dest="num_gpus",
                        help="cards per node to use (without a hostfile: "
                        "the local world size; default every card "
                        "nvidia-smi lists)")
    parser.add_argument("--master_addr", type=str, default="",
                        help="torch.distributed rendezvous address "
                        "(default: first host)")
    parser.add_argument("--master_port", type=int, default=29500)
    parser.add_argument("--launcher", type=str, default="pdsh",
                        choices=("pdsh", "ssh", "local", "openmpi",
                                 "mvapich"),
                        help="multi-node transport")
    parser.add_argument("--force_multi", action="store_true",
                        help="treat a single node as a multi-node launch")
    # ---- elastic training (docs/elastic.md) ----
    parser.add_argument("--elastic", action="store_true",
                        help="supervise the job: on worker failure or "
                        "missed heartbeats, kill the remnants, re-probe "
                        "the hosts, re-form the world from the survivors "
                        "at the reduced width, and relaunch resuming "
                        "from the newest verified checkpoint tag")
    parser.add_argument("--max-restarts", type=int, default=3,
                        dest="max_restarts",
                        help="relaunch budget before the supervisor "
                        "gives up with a typed error (0 = never restart)")
    parser.add_argument("--backoff-base", type=float, default=1.0,
                        dest="backoff_base",
                        help="exponential-backoff base seconds between "
                        "relaunches")
    parser.add_argument("--backoff-max", type=float, default=60.0,
                        dest="backoff_max",
                        help="backoff cap in seconds")
    parser.add_argument("--min-slots", type=int, default=1,
                        dest="min_slots",
                        help="smallest surviving card count worth "
                        "resuming at; below it the supervisor gives up")
    parser.add_argument("--heartbeat-dir", type=str, default="",
                        dest="heartbeat_dir",
                        help="shared dir for per-rank heartbeat files "
                        "(exported to workers as DS_HEARTBEAT_DIR; "
                        "default: a fresh temp dir — pass a shared-"
                        "filesystem path for multi-host liveness)")
    parser.add_argument("--heartbeat-timeout", type=float, default=0.0,
                        dest="heartbeat_timeout",
                        help="seconds without a heartbeat after which a "
                        "rank counts as hung and the attempt is killed "
                        "and restarted (0 = exit-watching only)")
    parser.add_argument("--probe-cmd", type=str, default="",
                        dest="probe_cmd",
                        help="shell command template probing one host "
                        "between attempts, '{host}' substituted; exit "
                        "!= 0 marks the host dead, and an optional "
                        "'slots=N' on stdout resizes it (default: ssh "
                        "-o ConnectTimeout=5 <host> true; localhost is "
                        "always alive)")
    parser.add_argument("user_script", type=str,
                        help="training script to launch")
    parser.add_argument("user_args", nargs=argparse.REMAINDER)
    return parser.parse_args(args=args)


def fetch_hostfile(hostfile_path: str) -> Optional[Dict[str, int]]:
    """Parse ``hostname slots=N`` lines → OrderedDict (reference
    runner.py:115-140: same format, duplicate-host error)."""
    if not os.path.isfile(hostfile_path):
        logger.warning("Unable to find hostfile %s; proceeding with local "
                       "resources only", hostfile_path)
        return None
    resource_pool: Dict[str, int] = collections.OrderedDict()
    with open(hostfile_path) as fd:
        for line in fd:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            try:
                hostname, slots = line.split()
                key, slot_count = slots.split("=")
                if key != "slots":
                    raise ValueError(key)
                slot_count = int(slot_count)
            except ValueError:
                raise ValueError(
                    f"Hostfile line not formatted as 'host slots=N': "
                    f"{line!r}")
            if hostname in resource_pool:
                raise ValueError(f"host {hostname} is already defined")
            resource_pool[hostname] = slot_count
    return resource_pool


def parse_resource_filter(host_info: Dict[str, List[int]],
                          include_str: str = "",
                          exclude_str: str = "") -> Dict[str, List[int]]:
    """Filter {host: [slots]} by include/exclude NODE_SPEC strings —
    the reference's exact semantics (runner.py:143-232): include builds
    from scratch, exclude removes, the two are mutually exclusive, empty
    hosts are dropped, hostfile ordering is preserved."""
    if include_str and exclude_str:
        raise ValueError("include_str and exclude_str are mutually "
                         "exclusive")
    if not include_str and not exclude_str:
        return host_info

    filtered: Dict[str, List[int]] = {}
    parse_str = include_str
    if exclude_str:
        filtered = deepcopy(host_info)
        parse_str = exclude_str

    which = "--include" if include_str else "--exclude"
    known = ", ".join(host_info) or "<empty hostfile>"
    for node_config in parse_str.split("@"):
        if not node_config:
            raise ValueError(
                f"{which} filter {parse_str!r} contains an empty "
                "NODE_SPEC (stray '@'?); expected "
                "NAME[:SLOT[,SLOT...]][@NAME...]")
        if ":" in node_config:
            parts = node_config.split(":")
            if len(parts) != 2:
                raise ValueError(
                    f"{which} NODE_SPEC {node_config!r} is malformed: "
                    "expected NAME or NAME:SLOT[,SLOT...] (one colon)")
            hostname, slot_str = parts
            try:
                slots = [int(x) for x in slot_str.split(",")]
            except ValueError:
                raise ValueError(
                    f"{which} NODE_SPEC {node_config!r} is malformed: "
                    f"slots must be comma-separated integers, got "
                    f"{slot_str!r}")
            if hostname not in host_info:
                raise ValueError(
                    f"{which} names hostname {hostname!r} which is not "
                    f"in the hostfile (hosts: {known}) — refusing to "
                    "silently ignore a filter that matches nothing")
            for s in slots:
                if s not in host_info[hostname]:
                    raise ValueError(
                        f"{which} names slot {s} on host {hostname!r}, "
                        f"which only has slots "
                        f"{host_info[hostname]}")
            if include_str:
                filtered[hostname] = slots
            else:
                for s in slots:
                    if s in filtered[hostname]:
                        filtered[hostname].remove(s)
        else:
            hostname = node_config
            if hostname not in host_info:
                raise ValueError(
                    f"{which} names hostname {hostname!r} which is not "
                    f"in the hostfile (hosts: {known}) — refusing to "
                    "silently ignore a filter that matches nothing")
            filtered[hostname] = host_info[hostname] if include_str else []

    for hostname in list(filtered):
        filtered[hostname] = sorted(set(filtered[hostname]))
        if not filtered[hostname]:
            del filtered[hostname]

    return collections.OrderedDict(
        (h, filtered[h]) for h in host_info if h in filtered)


def parse_inclusion_exclusion(resource_pool: Dict[str, int],
                              inclusion: str,
                              exclusion: str) -> Dict[str, List[int]]:
    active = collections.OrderedDict(
        (host, list(range(slots))) for host, slots in resource_pool.items())
    return parse_resource_filter(active, include_str=inclusion,
                                 exclude_str=exclusion)


def encode_world_info(world_info: Dict[str, List[int]]) -> str:
    """base64(json) world info passed to every node (reference
    runner.py:245-248)."""
    return base64.urlsafe_b64encode(
        json.dumps(world_info).encode()).decode()


def local_card_count(timeout_s: float = NVIDIA_SMI_TIMEOUT_S) -> int:
    """The cards ``nvidia-smi -L`` lists on this host (0 without the tool
    or when it fails or outlives ``timeout_s``).  A subprocess, so the
    launcher never imports torch or initializes CUDA itself."""
    try:
        r = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                           text=True, timeout=timeout_s)
    except (OSError, subprocess.SubprocessError):
        return 0
    if r.returncode != 0:
        return 0
    return sum(1 for line in r.stdout.splitlines()
               if line.startswith("GPU "))


def visible_cards(env=None) -> Optional[List[int]]:
    """The card indices an inherited ``CUDA_VISIBLE_DEVICES`` names (None
    when it is unset)."""
    env = os.environ if env is None else env
    value = env.get("CUDA_VISIBLE_DEVICES")
    if value is None:
        return None
    try:
        cards = [int(x) for x in value.split(",") if x.strip()]
    except ValueError:
        raise ValueError(
            f"CUDA_VISIBLE_DEVICES={value!r} is not a list of card "
            "indices, and the launcher places ranks by index: unset it "
            "and pass a hostfile with --include")
    if not cards or min(cards) < 0:
        raise ValueError(
            f"CUDA_VISIBLE_DEVICES={value!r} makes no card visible")
    return cards


def _local_pool(args) -> Dict[str, int]:
    """No hostfile: ``{"localhost": N}``, one slot a card.  Under an
    inherited ``CUDA_VISIBLE_DEVICES`` the pool is limited to its cards
    through ``args.include`` (upstream DeepSpeed's rule), so each rank's
    ``CUDA_VISIBLE_DEVICES`` still names a physical card of the grant."""
    if args.include or args.exclude:
        # a filter against a pool that does not exist can only be a
        # mistake (typo'd -H path is the common one) — silently
        # ignoring it would launch on resources the operator
        # explicitly tried to constrain
        raise ValueError(
            f"--include/--exclude were given but no hostfile exists "
            f"at {args.hostfile!r}; resource filters need a "
            "hostfile resource pool to filter")
    cards = visible_cards()
    if cards is not None:
        if args.num_gpus > len(cards):
            raise ValueError(
                f"--num_gpus {args.num_gpus}, but CUDA_VISIBLE_DEVICES "
                f"makes only {len(cards)} card(s) visible: {cards}")
        args.include = "localhost:" + ",".join(str(c) for c in cards)
        return collections.OrderedDict([("localhost", max(cards) + 1)])
    n = args.num_gpus
    if n <= 0:
        n = local_card_count()
        if n <= 0:
            raise ValueError(
                f"no hostfile at {args.hostfile!r} and no CUDA card "
                "listed by `nvidia-smi -L` on this host: pass "
                "--num_gpus N (one process a slot) or a hostfile")
    return collections.OrderedDict([("localhost", n)])


def _export_env_lines(extra_env_file: str = DEEPSPEED_ENVIRONMENT_NAME
                      ) -> Dict[str, str]:
    """Env vars propagated to remote nodes: the CUDA/NCCL/torch families
    plus any KEY=VALUE lines from a .deepspeed_env file (reference
    runner.py:27-29,340-351)."""
    exports = {}
    for key, val in os.environ.items():
        if any(key.startswith(p) for p in EXPORT_ENVS):
            exports[key] = val
    for candidate in (os.path.join(os.path.expanduser("~"),
                                   extra_env_file), extra_env_file):
        if os.path.isfile(candidate):
            with open(candidate) as f:
                for line in f:
                    line = line.strip()
                    if line and "=" in line and not line.startswith("#"):
                        k, v = line.split("=", 1)
                        exports[k] = v
            break
    return exports


_ASSIGNMENT = re.compile(r"[A-Za-z_][A-Za-z0-9_]*=")


def local_command(remote: str):
    """A remote command (``K=V ... python -m ...launch ...``) as
    ``(argv, env)`` to run on this host without a shell: the leading
    assignments become the env, the rest the argv."""
    parts = shlex.split(remote)
    env = dict(os.environ)
    while parts and _ASSIGNMENT.match(parts[0]):
        k, v = parts.pop(0).split("=", 1)
        env[k] = v
    return parts, env


def local_popen(remote: str) -> subprocess.Popen:
    """Start a remote command on this host (:func:`local_command`).  The
    handle is the per-node launcher itself, so a SIGTERM from the
    supervisor reaches it (and it forwards it to its ranks) instead of
    stopping at an intermediate shell."""
    argv, env = local_command(remote)
    return subprocess.Popen(argv, env=env)


def main(args=None):
    args = parse_args(args)
    resource_pool = fetch_hostfile(args.hostfile)
    if resource_pool is None:
        resource_pool = _local_pool(args)

    active = parse_inclusion_exclusion(resource_pool, args.include,
                                       args.exclude)
    if args.num_nodes > 0:
        active = collections.OrderedDict(
            list(active.items())[:args.num_nodes])
    if args.num_gpus > 0:
        active = collections.OrderedDict(
            (h, s[:args.num_gpus]) for h, s in active.items())
    if not active:
        raise ValueError("no resources left after include/exclude filters")

    master_addr = args.master_addr or next(iter(active))
    world_info = encode_world_info(active)
    exports = _export_env_lines()

    if args.elastic:
        return _run_elastic(args, active, exports)

    if args.launcher in ("openmpi", "mvapich"):
        # MPI flavor: ONE mpirun command covers every node (reference
        # multinode_runner.py:78-189), one process a host; each resolves
        # its node_rank from the MPI environment (launch.py
        # --node_rank=-1) and forks that host's slots
        from .multinode_runner import RUNNERS
        args.master_addr = master_addr
        runner = RUNNERS[args.launcher](args, world_info)
        runner.validate_args()
        if not runner.backend_exists():
            raise RuntimeError(
                f"launcher '{args.launcher}' selected but unavailable: "
                f"{runner.backend_missing_reason()}")
        cmd = runner.get_cmd(exports, active)
        logger.info("%s launch: %s", runner.name, " ".join(cmd))
        env = os.environ.copy()
        env.update(exports)
        return subprocess.call(cmd, env=env)

    # per-host fan-out: each node gets a distinct node_rank, so commands
    # differ per host and pdsh's single-command broadcast doesn't apply —
    # both transports dispatch one remote command per host, built by the
    # shared runner classes (one copy of the launch-command grammar)
    args.master_addr = master_addr
    fan_out, launch_cmds = _fan_out_cmds(args, active, exports)

    if args.launcher == "local" or (len(active) == 1
                                    and not args.force_multi):
        host, remote = launch_cmds[0]
        logger.info("local launch on %s", host)
        # the per-node launcher takes this process's place, so a
        # preemption SIGTERM sent to ds_torch reaches it and it forwards
        # it to its ranks
        argv, env = local_command(remote)
        sys.stdout.flush()
        sys.stderr.flush()
        os.execvpe(argv[0], argv, env)

    transport = ["pdsh", "-w"] if fan_out.name == "pdsh" else ["ssh"]
    procs = [subprocess.Popen(transport + [host, remote])
             for host, remote in launch_cmds]
    return max(p.wait() for p in procs)


def _fan_out_cmds(args, active, exports):
    """One (host, remote-command) pair per node via the shared runner
    classes — the single copy of the launch-command grammar, used by
    both the one-shot path and every elastic relaunch."""
    from .multinode_runner import PDSHRunner, SSHRunner
    world_info = encode_world_info(active)
    pdsh = PDSHRunner(args, world_info)
    fan_out = (pdsh if args.launcher == "pdsh" and pdsh.backend_exists()
               else SSHRunner(args, world_info))
    return fan_out, fan_out.get_cmd(exports, active)


def _build_probe(args, active):
    """Host-liveness probe for the elastic supervisor: --probe-cmd
    template (exit != 0 = dead; 'slots=N' on stdout resizes the host to
    the first N of the cards it was launched on in ``active``, so a shrink
    stays inside a filter or an inherited CUDA_VISIBLE_DEVICES; a host
    that grows takes cards 0..N-1), else ssh (localhost / --launcher
    local always alive)."""
    if args.probe_cmd:
        def probe(host):
            r = subprocess.run(args.probe_cmd.format(host=host),
                               shell=True, capture_output=True,
                               text=True, timeout=60)
            if r.returncode != 0:
                return None
            m = re.search(r"slots=(\d+)", r.stdout)
            if not m:
                return True
            n, cards = int(m.group(1)), active.get(host, [])
            return list(cards[:n]) if n <= len(cards) else list(range(n))
        return probe

    def probe(host):
        if args.launcher == "local" or host in ("localhost", "127.0.0.1"):
            return True
        r = subprocess.run(["ssh", "-o", "BatchMode=yes",
                            "-o", "ConnectTimeout=5", host, "true"],
                           capture_output=True, timeout=60)
        return True if r.returncode == 0 else None
    return probe


def _run_elastic(args, active, exports):
    """``ds_torch --elastic``: supervise the launch with the restart loop
    in launcher/elastic.py — worker exits + missed heartbeats trigger
    kill → host re-probe → world re-formation at the surviving width →
    relaunch, with the resumed run walking the checkpoint fallback
    chain to the newest verified tag (docs/elastic.md)."""
    import tempfile

    from .elastic import (ELASTIC_RESTART_ENV, ELASTIC_SLOTS_ENV,
                          ElasticSupervisor, RestartPolicy)

    if args.launcher in ("openmpi", "mvapich"):
        raise ValueError(
            "--elastic supports the pdsh/ssh/local launchers only: "
            "mpirun owns process placement, so the supervisor cannot "
            "re-form a shrunk world under it")
    hb_dir = args.heartbeat_dir or tempfile.mkdtemp(prefix="ds_heartbeat_")
    if not args.heartbeat_dir:
        logger.info("elastic: heartbeat dir %s (pass --heartbeat-dir on "
                    "a SHARED filesystem for multi-host liveness)",
                    hb_dir)
    user_master = args.master_addr  # explicit flag pins the rendezvous

    def launch(active_now, attempt):
        # re-derive the rendezvous host each attempt: the previous
        # rank-0 host may be the one that died
        args.master_addr = user_master or next(iter(active_now))
        exp = dict(exports)
        exp[ELASTIC_RESTART_ENV] = str(attempt)
        exp[ELASTIC_SLOTS_ENV] = str(
            sum(len(s) for s in active_now.values()))
        exp["DS_HEARTBEAT_DIR"] = hb_dir
        fan_out, cmds = _fan_out_cmds(args, active_now, exp)
        host0 = cmds[0][0]
        # in-process launch ONLY when the (single) host IS this machine:
        # a remote world shrunk to one surviving host must still go over
        # the transport — the survivor is not the supervisor's machine
        if args.launcher == "local" or (
                len(active_now) == 1 and not args.force_multi
                and host0 in ("localhost", "127.0.0.1")):
            host, remote = cmds[0]
            logger.info("elastic: local launch on %s (attempt %d)",
                        host, attempt)
            return [(host, local_popen(remote))]
        transport = ["pdsh", "-w"] if fan_out.name == "pdsh" else ["ssh"]
        return [(host, subprocess.Popen(transport + [host, remote]))
                for host, remote in cmds]

    def remote_kill(host):
        # best-effort remnant cleanup: SIGTERMing the local ssh/pdsh
        # client does not reach the remote launcher (no pty, no signal
        # forwarding), so a hung host would keep its cards and beat
        # files — pkill the user script by path on the host itself (the
        # per-node launcher's command line names it too)
        if host in ("localhost", "127.0.0.1"):
            return
        subprocess.run(
            ["ssh", "-o", "BatchMode=yes", "-o", "ConnectTimeout=5",
             host, f"pkill -TERM -f {shlex.quote(args.user_script)}"],
            capture_output=True, timeout=30)

    supervisor = ElasticSupervisor(
        active, launch, probe_fn=_build_probe(args, dict(active)),
        policy=RestartPolicy(max_restarts=args.max_restarts,
                             backoff_base_s=args.backoff_base,
                             backoff_max_s=args.backoff_max,
                             min_slots=args.min_slots),
        heartbeat_dir=hb_dir,
        heartbeat_timeout_s=args.heartbeat_timeout,
        remote_kill_fn=(None if args.launcher == "local"
                        else remote_kill))
    return supervisor.run()


if __name__ == "__main__":
    sys.exit(main())
