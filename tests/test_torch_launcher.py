"""The port's launcher (``deepspeed_tpu_torch/launcher/``, ``bin/ds_torch``)
against the JAX package's, and its one-process-per-card launch chain end
to end on gloo ranks.

- Parity: hostfile parsing, the include/exclude filters, world info,
  ``resolve_node_rank``, the CLI's flags and every runner's command equal
  the JAX package's on the same inputs (the same values, or the same
  exception type and message text); the commands differ only in the
  launch module's name.  The filters' messages are the reference code's
  own (``tests/test_aux.py:80,85`` expects others and fails on both
  packages).
- The env contract: ``build_env`` over a 2-host × {2, 1}-slot world and
  under ``--include``; the pool without a hostfile.
- End to end on localhost (gloo, ``device="cpu"``, one intra-op thread a
  rank): the two-host rehearsal through faked ssh and pdsh (2 hosts × 2
  slots = 4 ranks; each rank's first loss equals a one-process engine's
  at fp32 within 1e-5), and the per-node launcher's teardown: a rank
  that exits 1 takes its hung peer down within the grace period,
  SIGTERM reaches every rank, and a SIGKILLed launcher leaves no rank.
- The entry surface: the top-level names, ``init_distributed`` refusing
  the CPU by default, the tuning flags, ``FunctionalModule`` and the
  environment report.
"""
import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from test_torch_zero import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DS_TORCH = os.path.join(REPO, "bin", "ds_torch")
PORT_LAUNCH = "deepspeed_tpu_torch.launcher.launch"
JAX_LAUNCH = "deepspeed_tpu.launcher.launch"
#: one-process reference vs the 4-rank rehearsal, fp32
REHEARSAL_RTOL = 1e-5
#: seconds the teardown cases allow on top of the launcher's grace
MARGIN_S = 20.0


def _pkgs():
    import deepspeed_tpu.launcher.launch as jl
    import deepspeed_tpu.launcher.runner as jr
    import deepspeed_tpu_torch.launcher.launch as tl
    import deepspeed_tpu_torch.launcher.runner as tr
    return (jr, jl), (tr, tl)


def _outcome(fn, *args, **kwargs):
    """``("ok", value)`` or ``("raise", type name, message)``."""
    try:
        out = fn(*args, **kwargs)
    except Exception as e:  # the same type and text is the claim
        return ("raise", type(e).__name__, str(e))
    if isinstance(out, dict):
        return ("ok", list(out.items()))
    return ("ok", out)


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------
HOSTFILES = {
    "comments": "# chips per host\nworker-0 slots=4\nworker-1 slots=4\n",
    "duplicate": "w0 slots=4\nw0 slots=2\n",
    "bad_format": "w0 gpus=4\n",
    "bad_count": "w0 slots=x\n",
    "blank_lines": "\n\nnodeA slots=2\n\nnodeB slots=1\n",
}


@pytest.mark.parametrize("name", sorted(HOSTFILES) + ["missing"])
def test_fetch_hostfile_equals_jax(tmp_path, name):
    path = tmp_path / "hostfile"
    if name != "missing":
        path.write_text(HOSTFILES[name])
    (jr, _), (tr, _) = _pkgs()
    want = _outcome(jr.fetch_hostfile, str(path))
    assert _outcome(tr.fetch_hostfile, str(path)) == want
    if name == "comments":
        assert want == ("ok", [("worker-0", 4), ("worker-1", 4)])


POOL = {"worker-0": [0, 1, 2, 3], "worker-1": [0, 1, 2, 3]}
POOL2 = {"nodeA": [0, 1], "nodeB": [0, 1]}
# tests/test_aux.py:34-112 and tests/test_elastic.py:491-540, every case
FILTERS = [
    (POOL, "worker-0@worker-1:0,2", ""),
    (POOL, "", "worker-1:0"),
    (POOL, "", "worker-0"),
    (POOL, "worker-0", "worker-1"),
    (POOL, "worker-9", ""),
    (POOL, "worker-0:7", ""),
    (POOL, "worker-1@worker-0", ""),
    (POOL2, "ghost", ""),
    (POOL2, "", "ghost"),
    (POOL2, "ghost:0", ""),
    (POOL2, "nodeA:7", ""),
    ({"nodeA": [0, 1]}, "nodeA@", ""),
    ({"nodeA": [0, 1]}, "nodeA:0:1", ""),
    ({"nodeA": [0, 1]}, "nodeA:x", ""),
    ({"a": [0, 1], "b": [0, 1]}, "", "b:1"),
    ({}, "a", ""),
]


@pytest.mark.parametrize("pool,inc,exc", FILTERS,
                         ids=[f"{i}:{c[1] or '-'}:{c[2] or '-'}"
                              for i, c in enumerate(FILTERS)])
def test_resource_filter_equals_jax(pool, inc, exc):
    (jr, _), (tr, _) = _pkgs()
    want = _outcome(jr.parse_resource_filter, pool, inc, exc)
    assert _outcome(tr.parse_resource_filter, pool, inc, exc) == want


def test_filter_messages_are_the_reference_codes_own():
    """The port raises the reference code's messages
    (``deepspeed_tpu/launcher/runner.py:181-191``), not the ones
    ``tests/test_aux.py::test_filter_unknown_host`` / ``_slot`` expect
    ("not found", "No slot"): those two fail on both packages."""
    from deepspeed_tpu_torch.launcher.runner import parse_resource_filter
    with pytest.raises(ValueError, match="which is not in the hostfile"):
        parse_resource_filter(POOL, include_str="worker-9")
    with pytest.raises(ValueError, match="which only has slots"):
        parse_resource_filter(POOL, include_str="worker-0:7")


def test_inclusion_exclusion_and_world_info_cross_decode():
    (jr, jl), (tr, tl) = _pkgs()
    for pool, inc, exc in (({"a": 4, "b": 4}, "", "b:1,3"),
                           ({"a": 2, "b": 1}, "a:1@b", ""),
                           ({"x": 8}, "", "")):
        active = tr.parse_inclusion_exclusion(pool, inc, exc)
        assert list(active.items()) == list(
            jr.parse_inclusion_exclusion(pool, inc, exc).items())
        enc = tr.encode_world_info(active)
        assert enc == jr.encode_world_info(active)
        assert jl.decode_world_info(enc) == tl.decode_world_info(
            jr.encode_world_info(active)) == active


@pytest.mark.parametrize("rank,env", [
    (3, None), (0, {}), (-1, {"OMPI_COMM_WORLD_RANK": "2"}),
    (-1, {"MV2_COMM_WORLD_RANK": "1"}), (-1, {"PMI_RANK": "0"}),
    (-1, {"OMPI_COMM_WORLD_RANK": "1", "PMI_RANK": "5"}), (-1, {})])
def test_resolve_node_rank_equals_jax(rank, env):
    (_, jl), (_, tl) = _pkgs()
    want = _outcome(jl.resolve_node_rank, rank, env)
    assert _outcome(tl.resolve_node_rank, rank, env) == want


ARGV = ["--hostfile", "HF", "--include", "nodeA:0,1", "--num_nodes", "2",
        "--num_gpus", "2", "--master_addr", "10.0.0.1", "--master_port",
        "1234", "--launcher", "ssh", "--force_multi", "--elastic",
        "--max-restarts", "5", "--backoff-base", "0.5", "--backoff-max",
        "9", "--min-slots", "2", "--heartbeat-dir", "/hb",
        "--heartbeat-timeout", "30", "--probe-cmd", "probe {host}",
        "train.py", "--lr", "0.1"]


@pytest.mark.parametrize("argv", [ARGV, ["train.py"],
                                  ["--num_chips", "3", "t.py", "x"]])
def test_cli_flags_equal_jax(argv):
    (jr, _), (tr, _) = _pkgs()
    assert vars(tr.parse_args(argv)) == vars(jr.parse_args(argv))


def _runner_cmds(pkg, name, hostfile, env, active):
    import importlib
    mr = importlib.import_module(pkg + ".launcher.multinode_runner")
    rn = importlib.import_module(pkg + ".launcher.runner")
    args = rn.parse_args(["--hostfile", str(hostfile), "--launcher", name,
                          "train.py", "--lr", "0.1"])
    args.master_addr = "nodeA"
    runner = mr.RUNNERS[name](args, "WORLDINFO")
    cmd = runner.get_cmd(env, active)
    if name != "mvapich":
        return cmd, None
    i = cmd.index("-hostfile") + 1
    with open(cmd[i]) as f:
        hosts = f.read()
    return cmd[:i] + ["<hostfile>"] + cmd[i + 1:], hosts


@pytest.mark.parametrize("name", ["pdsh", "ssh", "openmpi", "mvapich"])
def test_runner_commands_equal_jax_but_the_module(tmp_path, name):
    """Each runner's command is the reference runner's byte for byte,
    bar the launch module: one process per host (``-n <hosts>``,
    ``ppr:1:node`` / ``-ppn 1``, ``--node_rank=-1`` under MPI) that forks
    its host's slots."""
    hf = tmp_path / "hostfile"
    hf.write_text("nodeA slots=4\nnodeB slots=2\n")
    env = {"PYTHONPATH": "/x", "NCCL_DEBUG": "INFO", "K": "a b"}
    active = {"nodeA": [0, 1, 2, 3], "nodeB": [0, 1]}
    got, got_hosts = _runner_cmds("deepspeed_tpu_torch", name, hf, env,
                                  active)
    want, want_hosts = _runner_cmds("deepspeed_tpu", name, hf, env, active)
    assert json.dumps(got).count(PORT_LAUNCH) == len(
        active if name in ("pdsh", "ssh") else [0])
    assert json.dumps(got).replace(PORT_LAUNCH, JAX_LAUNCH) \
        == json.dumps(want)
    assert got_hosts == want_hosts
    if name in ("openmpi", "mvapich"):
        assert got[:3] == ["mpirun", "-n", "2"] and "--node_rank=-1" in got


def test_mpi_runners_refuse_filters_and_elastic(tmp_path):
    from deepspeed_tpu_torch.launcher.multinode_runner import OpenMPIRunner
    from deepspeed_tpu_torch.launcher.runner import main, parse_args
    hf = tmp_path / "hostfile"
    hf.write_text("localhost slots=1\n")
    args = parse_args(["--hostfile", str(hf), "--launcher", "openmpi",
                       "--include", "localhost", "train.py"])
    with pytest.raises(ValueError, match="placement"):
        OpenMPIRunner(args, "W").validate_args()
    with pytest.raises(ValueError, match="mpirun owns"):
        main(["--hostfile", str(hf), "--launcher", "openmpi", "--elastic",
              "train.py"])
    for flag in ("--include", "--exclude"):
        with pytest.raises(ValueError, match="no hostfile exists"):
            main(["--hostfile", str(tmp_path / "nope"), flag, "ghost",
                  "train.py"])


def test_export_env_families(monkeypatch, tmp_path):
    """The env a CUDA job needs reaches every host (the CUDA, NCCL,
    torch, OpenMP and Python families, PATH, DS_*); the JAX families do
    not; ``.deepspeed_env`` lines are added."""
    from deepspeed_tpu_torch.launcher.runner import _export_env_lines
    for k in ("CUDA_VISIBLE_DEVICES", "NCCL_DEBUG", "TORCH_LOGS",
              "OMP_NUM_THREADS", "DS_PREFETCH", "DEEPSPEED_TPU_X"):
        monkeypatch.setenv(k, "1")
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setenv("XLA_FLAGS", "x")
    monkeypatch.setenv("HOME", str(tmp_path))
    (tmp_path / ".deepspeed_env").write_text("# c\nNCCL_IB_DISABLE=1\n")
    out = _export_env_lines()
    for k in ("CUDA_VISIBLE_DEVICES", "NCCL_DEBUG", "TORCH_LOGS",
              "OMP_NUM_THREADS", "DS_PREFETCH", "DEEPSPEED_TPU_X", "PATH"):
        assert out[k] == os.environ[k]
    assert out["NCCL_IB_DISABLE"] == "1"
    assert "JAX_PLATFORMS" not in out and "XLA_FLAGS" not in out


# ---------------------------------------------------------------------------
# the env contract and the pool
# ---------------------------------------------------------------------------
def test_build_env_one_process_per_card():
    """2 hosts × {2, 1} slots: ranks 0–2 in host order, LOCAL_RANK the
    slot's index, WORLD_SIZE 3, CUDA_VISIBLE_DEVICES the host's slots;
    under ``--include h0:1@h1`` rank 0 runs on h0's physical card 1."""
    from deepspeed_tpu_torch.launcher import (build_env, decode_world_info,
                                              encode_world_info,
                                              parse_inclusion_exclusion)
    world = decode_world_info(encode_world_info(
        parse_inclusion_exclusion({"h0": 2, "h1": 1}, "", "")))
    got = [(n, lr, build_env(world, n, "h0", 1234, base_env={},
                             local_rank=lr)) for n, lr in
           ((0, 0), (0, 1), (1, 0))]
    for rank, (n, lr, env) in enumerate(got):
        assert env == {"MASTER_ADDR": "h0", "MASTER_PORT": "1234",
                       "RANK": str(rank), "LOCAL_RANK": str(lr),
                       "WORLD_SIZE": "3",
                       "CUDA_VISIBLE_DEVICES": "0,1" if n == 0 else "0"}
    inc = parse_inclusion_exclusion({"h0": 4, "h1": 2}, "h0:1,3@h1", "")
    env = build_env(inc, 0, "h0", 1, base_env={"X": "y"}, local_rank=1)
    assert env["CUDA_VISIBLE_DEVICES"] == "1,3" and env["X"] == "y"
    assert env["RANK"] == "1" and env["WORLD_SIZE"] == "4"
    assert build_env(inc, 1, "h0", 1, base_env={}, local_rank=1)["RANK"] \
        == "3"
    with pytest.raises(ValueError, match="node_rank 2 out of range"):
        build_env(inc, 2, "h0", 1, base_env={})
    with pytest.raises(ValueError, match="local_rank 2 out of range"):
        build_env(inc, 0, "h0", 1, base_env={}, local_rank=2)


def test_pool_without_hostfile(monkeypatch, tmp_path):
    """No hostfile: ``--num_gpus N``, else the cards ``nvidia-smi -L``
    lists (a subprocess with a deadline), else a ValueError that says
    so."""
    from deepspeed_tpu_torch.launcher import runner
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    fake = tmp_path / "bin"
    fake.mkdir()
    smi = fake / "nvidia-smi"
    smi.write_text("#!/bin/sh\necho 'GPU 0: NVIDIA H100 (UUID: a)'\n"
                   "echo 'GPU 1: NVIDIA H100 (UUID: b)'\n")
    smi.chmod(0o755)
    monkeypatch.setenv("PATH", f"{fake}{os.pathsep}{os.environ['PATH']}")
    assert runner.local_card_count() == 2
    args = runner.parse_args(["--hostfile", str(tmp_path / "nope"), "t.py"])
    assert runner._local_pool(args) == {"localhost": 2}
    assert runner._local_pool(runner.parse_args(
        ["--num_gpus", "3", "t.py"])) == {"localhost": 3}
    smi.write_text("#!/bin/sh\nexit 9\n")
    assert runner.local_card_count() == 0
    monkeypatch.setattr(runner, "local_card_count", lambda: 0)
    with pytest.raises(ValueError, match="nvidia-smi -L.*--num_gpus"):
        runner.main(["--hostfile", str(tmp_path / "nope"), "t.py"])


def test_inherited_cuda_visible_devices_limits_the_pool(monkeypatch,
                                                        tmp_path):
    """A scheduler's ``CUDA_VISIBLE_DEVICES=2,3`` with no hostfile: the
    pool is those two cards (``--num_gpus`` takes the first of them), and
    each rank's ``CUDA_VISIBLE_DEVICES`` names physical cards 2 and 3, so
    rank 0 runs on card 2.  ``nvidia-smi -L`` is not asked.  A hostfile
    keeps its own slots; a list that names no card index is refused."""
    from deepspeed_tpu_torch.launcher import runner
    from deepspeed_tpu_torch.launcher.launch import build_env
    monkeypatch.setattr(runner, "local_card_count", lambda: 8)
    nope = str(tmp_path / "nope")

    def active(*argv):
        args = runner.parse_args(["--hostfile", nope, *argv, "t.py"])
        pool = runner._local_pool(args)
        got = runner.parse_inclusion_exclusion(pool, args.include,
                                               args.exclude)
        if args.num_gpus > 0:
            got = {h: s[:args.num_gpus] for h, s in got.items()}
        return dict(got)

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2,3")
    assert runner.visible_cards() == [2, 3]
    world = active()
    assert world == {"localhost": [2, 3]}
    assert [build_env(world, 0, "h", 1, base_env={}, local_rank=r)[
        "CUDA_VISIBLE_DEVICES"] for r in range(2)] == ["2,3", "2,3"]
    assert active("--num_gpus", "1") == {"localhost": [2]}
    with pytest.raises(ValueError, match="only 2 card"):
        active("--num_gpus", "3")
    hf = tmp_path / "hostfile"
    hf.write_text("localhost slots=2\n")
    assert runner.parse_inclusion_exclusion(
        runner.fetch_hostfile(str(hf)), "", "") == {"localhost": [0, 1]}
    # an elastic probe's 'slots=1' shrinks the host to the first of its
    # cards, not to card 0
    assert [runner._build_probe(runner.parse_args(
        ["--probe-cmd", f"echo {{host}} slots={n}", "t.py"]), world)(
            "localhost") for n in (1, 2, 3)] == [[2], [2, 3], [0, 1, 2]]
    for bad, msg in (("GPU-1a2b", "not a list of card indices"),
                     ("", "no card"), ("-1", "no card")):
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", bad)
        with pytest.raises(ValueError, match=msg):
            active()


# ---------------------------------------------------------------------------
# end to end: ds_torch → runner → (faked) transport → launch.py → ranks
# ---------------------------------------------------------------------------
#: the model every worker trains: a linear map in fp32, params from a
#: numpy seed (``FunctionalModule`` over bare functions)
MODEL_SRC = r'''
import numpy as np

HIDDEN = 8


def init(seed):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((HIDDEN, HIDDEN)) * 0.1)
            .astype(np.float32), "b": np.zeros(HIDDEN, np.float32)}


def loss(params, batch, rng, train=True):
    x, y = batch
    return ((x @ params["w"] + params["b"] - y) ** 2).mean()


def global_batch(rows=8):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((rows, HIDDEN)).astype(np.float32)
    return x, (0.5 * x).astype(np.float32)
'''

REHEARSAL_WORKER = MODEL_SRC + r'''
import json, os, sys
import torch
torch.set_num_threads(1)
import deepspeed_tpu_torch as ds
from deepspeed_tpu_torch.runtime.dataloader import rank_rows

out_dir = sys.argv[1]
# launch.py's env contract feeds torch.distributed through the public API
assert ds.init_distributed(device="cpu")
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
engine, *_ = ds.initialize(
    model=ds.FunctionalModule(init, loss), device="cpu",
    config={"train_micro_batch_size_per_gpu": 2,
            "gradient_accumulation_steps": 1, "steps_per_print": 10 ** 9,
            "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}})
rows = rank_rows(global_batch(), 1, engine.dp_world_size,
                 engine.mesh.axis_index("data"))
losses = [float(engine.train_batch(rows)) for _ in range(3)]
engine.close()
backend = torch.distributed.get_backend()
torch.distributed.barrier()
torch.distributed.destroy_process_group()
json.dump({"rank": rank, "world": world, "dp": engine.dp_world_size,
           "local_rank": os.environ["LOCAL_RANK"],
           "cvd": os.environ["CUDA_VISIBLE_DEVICES"],
           "backend": backend, "losses": losses},
          open(os.path.join(out_dir, f"rank{rank}.json"), "w"))
'''


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def worker_env(**extra) -> dict:
    """The env of a ``ds_torch`` run in a test: one intra-op thread a
    rank, no elastic or heartbeat leftovers of the caller's."""
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"
    env["DS_CKPT_FSYNC"] = "0"
    for k in ("DS_ELASTIC_RESTART", "DS_ELASTIC_WORLD_SLOTS",
              "DS_HEARTBEAT_DIR", "MASTER_ADDR", "MASTER_PORT", "RANK",
              "WORLD_SIZE", "LOCAL_RANK", "CUDA_VISIBLE_DEVICES"):
        env.pop(k, None)
    env.update(extra)
    return env


def run_ds_torch(args, env, timeout=300):
    proc = subprocess.run([sys.executable, DS_TORCH] + list(args), env=env,
                          timeout=timeout, capture_output=True, text=True)
    return proc


def _fake_transport(tmp_path, flavor):
    """A PATH-shadowing ssh/pdsh that runs the remote command on this
    host (the command string is exactly what a real transport would run
    on the target) and logs which host it was for."""
    bin_dir = tmp_path / "fakebin"
    bin_dir.mkdir(exist_ok=True)
    log = tmp_path / f"{flavor}_hosts.log"
    shift = "shift\n" if flavor == "pdsh" else ""  # pdsh: -w <host> <cmd>
    exe = bin_dir / flavor
    exe.write_text(f"#!/bin/bash\n{shift}echo \"$1\" >> {log}\nshift\n"
                   "exec bash -c \"$*\"\n")
    exe.chmod(0o755)
    return bin_dir, log


def _one_process_losses():
    import deepspeed_tpu_torch as ds
    ns = {}
    exec(MODEL_SRC, ns)
    engine, *_ = ds.initialize(
        model=ds.FunctionalModule(ns["init"], ns["loss"]), device="cpu",
        config={"train_micro_batch_size_per_gpu": 8,
                "gradient_accumulation_steps": 1,
                "steps_per_print": 10 ** 9,
                "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}})
    out = [float(engine.train_batch(ns["global_batch"]()))
           for _ in range(3)]
    engine.close()
    return out


@pytest.mark.parametrize("flavor", ["ssh", "pdsh"])
def test_two_host_rehearsal_one_process_per_card(tmp_path, flavor):
    """``ds_torch --hostfile`` of 2 hosts × 2 slots: the runner builds one
    remote command a host, the faked transport runs it, each host's
    launch.py forks 2 ranks, and the 4 join one gloo group: ranks 0–3,
    local ranks 0/1, ``CUDA_VISIBLE_DEVICES`` "0,1".  Every rank's losses
    equal a one-process engine's on the whole batch (fp32, 1e-5)."""
    script = tmp_path / "worker.py"
    script.write_text(REHEARSAL_WORKER)
    out = tmp_path / "out"
    out.mkdir()
    hf = tmp_path / "hostfile"
    hf.write_text("nodeA slots=2\nnodeB slots=2\n")
    bin_dir, host_log = _fake_transport(tmp_path, flavor)
    env = worker_env(PATH=f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    proc = run_ds_torch(["--hostfile", str(hf), "--launcher", flavor,
                         "--master_addr", "127.0.0.1", "--master_port",
                         str(free_port()), str(script), str(out)], env)
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-3000:])
    assert sorted(host_log.read_text().split()) == ["nodeA", "nodeB"]
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(4)]
    assert [(r["rank"], r["local_rank"], r["world"], r["dp"], r["cvd"],
             r["backend"]) for r in ranks] == [
        (i, str(i % 2), 4, 4, "0,1", "gloo") for i in range(4)]
    ref = _one_process_losses()
    for r in ranks:
        np.testing.assert_allclose(r["losses"], ref, rtol=REHEARSAL_RTOL)
        assert r["losses"] == ranks[0]["losses"]
    assert ref[-1] < ref[0]


PID_WORKER = r'''
import os, signal, sys, time
out, mode = sys.argv[1], sys.argv[2]
rank = int(os.environ["RANK"])
if mode == "hang" and rank == 1:
    signal.signal(signal.SIGTERM, signal.SIG_IGN)  # only SIGKILL ends it
if mode == "term":
    def on_term(signum, frame):
        open(os.path.join(out, f"term{rank}"), "w").write("1")
        sys.exit(0)
    signal.signal(signal.SIGTERM, on_term)
open(os.path.join(out, f"pid{rank}.tmp"), "w").write(str(os.getpid()))
os.rename(os.path.join(out, f"pid{rank}.tmp"), os.path.join(out, f"pid{rank}"))
if mode == "hang" and rank == 0:
    while not os.path.exists(os.path.join(out, "pid1")):
        time.sleep(0.01)
    sys.exit(1)
time.sleep(600)
'''


def _alive(pid: int) -> bool:
    """Running (a zombie or a missing /proc entry counts as gone)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (FileNotFoundError, ProcessLookupError):
        return False


def _pids(out, n, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all((out / f"pid{r}").exists() for r in range(n)):
            return [int((out / f"pid{r}").read_text()) for r in range(n)]
        time.sleep(0.02)
    raise AssertionError(f"the ranks wrote no pid in {timeout} s")


def _launch_cmd(script, out, mode, slots=2):
    from deepspeed_tpu_torch.launcher import encode_world_info
    world = encode_world_info({"localhost": list(range(slots))})
    return [sys.executable, "-m", PORT_LAUNCH, f"--world_info={world}",
            "--node_rank=0", "--master_addr=127.0.0.1",
            f"--master_port={free_port()}", str(script), str(out), mode]


def test_launcher_teardown_signals_and_parent_death(tmp_path):
    """The per-node launcher stays its ranks' parent.  (a) Rank 1 hangs
    ignoring SIGTERM and rank 0 exits 1: ``ds_torch`` exits 1 within the
    grace period (plus start-up), and every rank's pid is gone.  (b) A
    SIGTERM to the launcher reaches every rank (their handlers run) and
    it exits 0 once they have.  (c) A SIGKILLed launcher takes its ranks
    with it (``PR_SET_PDEATHSIG``): none is left holding a card or the
    port.  (d) A SIGTERM to ``ds_torch`` itself (a preemption) reaches
    every rank too: on one host the launcher takes the runner's place."""
    script = tmp_path / "pid_worker.py"
    script.write_text(PID_WORKER)
    hf = tmp_path / "hostfile"
    hf.write_text("localhost slots=2\n")
    from deepspeed_tpu_torch.launcher.launch import TERM_GRACE_S
    env = worker_env()
    # (a)
    out = tmp_path / "a"
    out.mkdir()
    t0 = time.monotonic()
    proc = run_ds_torch(["--hostfile", str(hf), "--launcher", "local",
                         "--master_port", str(free_port()), str(script),
                         str(out), "hang"], env, timeout=120)
    wall = time.monotonic() - t0
    assert proc.returncode == 1, proc.stderr[-2000:]
    assert wall < TERM_GRACE_S + MARGIN_S, wall
    assert not any(_alive(p) for p in _pids(out, 2, timeout=1))
    # (b)
    out = tmp_path / "b"
    out.mkdir()
    launcher = subprocess.Popen(_launch_cmd(script, out, "term"), env=env)
    pids = _pids(out, 2)
    launcher.send_signal(signal.SIGTERM)
    assert launcher.wait(timeout=60) == 0
    assert all((out / f"term{r}").exists() for r in range(2))
    assert not any(_alive(p) for p in pids)
    # (c)
    out = tmp_path / "c"
    out.mkdir()
    launcher = subprocess.Popen(_launch_cmd(script, out, "sleep"), env=env)
    pids = _pids(out, 2)
    launcher.kill()
    launcher.wait()
    deadline = time.monotonic() + MARGIN_S
    while any(_alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not any(_alive(p) for p in pids)
    # (d)
    out = tmp_path / "d"
    out.mkdir()
    ds = subprocess.Popen([sys.executable, DS_TORCH, "--hostfile", str(hf),
                           "--launcher", "local", "--master_port",
                           str(free_port()), str(script), str(out), "term"],
                          env=env)
    pids = _pids(out, 2)
    ds.send_signal(signal.SIGTERM)
    assert ds.wait(timeout=60) == 0
    assert all((out / f"term{r}").exists() for r in range(2))
    assert not any(_alive(p) for p in pids)


# ---------------------------------------------------------------------------
# the entry surface
# ---------------------------------------------------------------------------
#: tests/test_lr_schedules.py:113-118's names, and what a launched
#: script or a data pipeline reaches for
TOP_LEVEL = ["initialize", "add_config_arguments", "add_tuning_arguments",
             "DeepSpeedEngine", "PipelineEngine", "DeepSpeedConfig",
             "PipelineModule", "DeepSpeedTransformerLayer",
             "DeepSpeedTransformerConfig", "log_dist", "checkpointing",
             "ADAM_OPTIMIZER", "LAMB_OPTIMIZER", "__version__",
             "init_distributed", "DeepSpeedConfigError", "TrainModule",
             "FunctionalModule", "DeepSpeedDataLoader", "RepeatingLoader",
             "DevicePlacedBatch", "DevicePrefetcher", "__git_hash__",
             "__git_branch__"]


def test_top_level_exports_match_jax():
    import deepspeed_tpu
    import deepspeed_tpu_torch
    for name in TOP_LEVEL:
        assert hasattr(deepspeed_tpu_torch, name), name
        assert hasattr(deepspeed_tpu, name), name
    assert set(deepspeed_tpu_torch.__all__) >= {
        n for n in TOP_LEVEL if not n.startswith("__git")}
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine
    from deepspeed_tpu_torch.runtime.prefetch import DevicePrefetcher
    assert deepspeed_tpu_torch.DeepSpeedEngine is DeepSpeedEngine
    assert deepspeed_tpu_torch.DevicePrefetcher is DevicePrefetcher
    assert deepspeed_tpu_torch.ADAM_OPTIMIZER == deepspeed_tpu.ADAM_OPTIMIZER
    with pytest.raises(AttributeError):
        deepspeed_tpu_torch.FlaxModule


def test_launcher_and_package_import_no_torch():
    """The runner, the per-node launcher, the MPI runners and the elastic
    supervisor (and the package itself) load no torch: a supervisor must
    keep running when the worker runtime is what broke."""
    code = ("import sys\n"
            "sys.modules['torch'] = None\n"
            "import deepspeed_tpu_torch\n"
            "from deepspeed_tpu_torch.launcher import (runner, launch, "
            "multinode_runner, elastic, supervise, build_env)\n"
            "runner.parse_args(['t.py'])\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0 and "ok" in proc.stdout, proc.stderr


def test_config_and_tuning_arguments_equal_jax(monkeypatch):
    import deepspeed_tpu
    import deepspeed_tpu.runtime.lr_schedules as jlr
    import deepspeed_tpu_torch
    import deepspeed_tpu_torch.runtime.lr_schedules as tlr
    for argv in (["--deepspeed", "--deepspeed_config", "ds.json"], [],
                 ["--deepscale", "--deepscale_config", "x.json"]):
        parsed = [vars(m.add_config_arguments(
            argparse.ArgumentParser()).parse_args(argv))
            for m in (deepspeed_tpu, deepspeed_tpu_torch)]
        assert parsed[0] == parsed[1]
    for argv in (["--lr_schedule", "OneCycle", "--cycle_max_lr", "0.3"],
                 ["--lr_schedule", "WarmupDecayLR", "--total_num_steps",
                  "9", "--lr_range_test_staircase", "false"],
                 ["--lr_schedule", "WarmupDecayLR"],
                 ["--lr_schedule", "Nope"], []):
        got = [_outcome(m.schedule_params_from_args, m.add_tuning_arguments(
            argparse.ArgumentParser()).parse_args(argv))
            for m in (jlr, tlr)]
        assert got[0] == got[1], argv
    monkeypatch.setattr(sys, "argv", ["p", "--warmup_num_steps", "7", "-z"])
    assert _outcome(tlr.parse_arguments) == _outcome(jlr.parse_arguments)
    blk = tlr.schedule_params_from_args(tlr.add_tuning_arguments(
        argparse.ArgumentParser()).parse_args(
        ["--lr_schedule", "WarmupLR", "--warmup_max_lr", "0.5",
         "--warmup_num_steps", "10"]))
    sched = tlr.get_lr_schedule(blk["type"], blk["params"])
    assert float(sched(10)) == pytest.approx(0.5)


def test_functional_module_trains():
    import deepspeed_tpu_torch as ds
    ns = {}
    exec(MODEL_SRC, ns)
    mod = ds.FunctionalModule(ns["init"], ns["loss"],
                              partition_spec_fn=lambda p: None)
    assert isinstance(mod, ds.TrainModule)
    assert mod.param_partition_specs({}) is None
    losses = _one_process_losses()
    assert losses[-1] < losses[0] and all(np.isfinite(losses))


def test_init_distributed_refuses_the_cpu_by_default(monkeypatch,
                                                     tmp_path):
    """A launched script's ``init_distributed()`` with the env contract and
    no CUDA device raises instead of joining on the CPU; ``device="cpu"``
    joins gloo; ``initialize()`` without a device raises the same."""
    import torch.distributed as dist
    import deepspeed_tpu_torch as ds
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for k, v in (("MASTER_ADDR", "127.0.0.1"),
                 ("MASTER_PORT", str(free_port())), ("RANK", "0"),
                 ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ds.init_distributed()
    with pytest.raises(RuntimeError, match="CUDA, which is not available"):
        ds.init_distributed(device="cuda")
    ns = {}
    exec(MODEL_SRC, ns)
    model = ds.FunctionalModule(ns["init"], ns["loss"])
    cfg = {"train_micro_batch_size_per_gpu": 1}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ds.initialize(model=model, config=cfg)
    assert not dist.is_initialized()
    try:
        assert ds.init_distributed(device="cpu")
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        assert not ds.init_distributed(device="cpu")  # idempotent
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_env_report_names_the_port_and_every_kernel_library():
    from deepspeed_tpu_torch import env_report
    from deepspeed_tpu_torch.git_version_info import kernel_libraries
    rows = dict(env_report.collect_report())
    for key in ("python", "torch", "numpy", "nvcc", "CUDA_HOME", "devices",
                "native host ops", "deepspeed_tpu_torch"):
        assert key in rows, key
    for lib in kernel_libraries():
        assert rows[f"kernel {lib}"] in (
            "built", "not built (built on first use)",
            "UNAVAILABLE (no nvcc)")
    assert not any(k.startswith(("jax", "flax", "optax")) for k in rows)
    proc = subprocess.run([sys.executable,
                           os.path.join(REPO, "bin", "ds_report_torch")],
                          capture_output=True, text=True, timeout=120,
                          env=worker_env(DS_REPORT_DEVICE_TIMEOUT="60"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "deepspeed_tpu_torch environment report" in proc.stdout
    assert "devices" in proc.stdout and "jax" not in proc.stdout.lower()
