"""``ds_torch --elastic`` (``deepspeed_tpu_torch/launcher/elastic.py`` over
the one-process-per-card launch chain) against the JAX package's
supervisor and its end-to-end bars.

- The supervisor's unit cases (``tests/test_elastic.py:386-490,
  701-747``: restart and shrink, the typed give-up after the budget and
  below ``min_slots``, a probe's resize, missed heartbeats, the shutdown
  skew, remote cleanup), each run on both packages' ``ElasticSupervisor``.
- End to end on localhost, gloo ranks with ``device="cpu"`` and one
  intra-op thread each, a worker written from a string that trains
  through the engine's own loader chain (``DeepSpeedDataLoader`` →
  ``RepeatingLoader`` → the prefetcher, each rank slicing its rows of the
  global batch) and checkpoints every step:
  - kill and resume at 2 slots: after step 3 rank 0 hard-exits while
    rank 1 waits in its next step's collective; the per-node launcher
    tears rank 1 down, the supervisor relaunches, and the stitched run
    is sample-exact with losses bitwise the uninterrupted run's (the
    bar of ``tests/test_elastic.py:573-608``);
  - resize 2 → 1 through ``--probe-cmd``: the resumed dp-1 run restores
    the global loader state the dp-2 ranks saved and equals a
    dp-1-from-start run at rtol 1e-5 (``:611-648``'s bar).
"""
import collections
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from test_torch_launcher import (MODEL_SRC, free_port, run_ds_torch,
                                 worker_env)
from test_torch_zero import one_thread  # noqa: F401

#: the dp-1 resume against dp 1 from the start, fp32
RESIZE_RTOL = 1e-5
STEPS, CRASH_AT = 6, 3


def _supervisor(pkg):
    import importlib
    return importlib.import_module(pkg + ".launcher.elastic")


PKGS = ["deepspeed_tpu", "deepspeed_tpu_torch"]


def _read_heartbeats(pkg, d):
    import importlib
    return importlib.import_module(
        pkg + ".telemetry.heartbeat").read_heartbeats(d)


# ---------------------------------------------------------------------------
# supervisor semantics (unit tier: stub workers), both packages
# ---------------------------------------------------------------------------
def _proc(code="import sys; sys.exit(0)"):
    return subprocess.Popen([sys.executable, "-c", code])


@pytest.mark.parametrize("pkg", PKGS)
def test_supervisor_restarts_and_shrinks_world(pkg):
    el = _supervisor(pkg)
    calls = []

    def launch(active, attempt):
        calls.append((dict(active), attempt))
        return [("a", _proc(
            f"import sys; sys.exit({3 if attempt == 0 else 0})"))]

    slept = []
    sup = el.ElasticSupervisor(
        collections.OrderedDict([("a", [0, 1]), ("b", [0, 1])]),
        launch, probe_fn=lambda h: None if h == "b" else True,
        policy=el.RestartPolicy(max_restarts=2, backoff_base_s=0.5),
        sleep_fn=slept.append)
    assert sup.run() == 0
    assert calls[0][0] == {"a": [0, 1], "b": [0, 1]}
    assert calls[1][0] == {"a": [0, 1]}  # b dropped after its probe
    assert calls[1][1] == 1              # DS_ELASTIC_RESTART advances
    assert slept == [0.5]


@pytest.mark.parametrize("pkg", PKGS)
def test_supervisor_gives_up_typed_after_budget(pkg, tmp_path):
    el = _supervisor(pkg)
    slept = []
    sup = el.ElasticSupervisor(
        {"a": [0]}, lambda active, attempt: [("a", _proc(
            "import sys; sys.exit(1)"))],
        policy=el.RestartPolicy(max_restarts=3, backoff_base_s=1.0,
                                backoff_max_s=3.0),
        heartbeat_dir=str(tmp_path), sleep_fn=slept.append)
    with pytest.raises(el.ElasticGiveUpError) as ei:
        sup.run()
    assert ei.value.restarts == 3
    assert "rc=1" in ei.value.last_failure
    assert slept == [1.0, 2.0, 3.0]  # exponential, capped at backoff_max
    rec = json.loads((tmp_path / "flightrec_supervisor.json").read_text())
    events = rec["stages"]["supervisor"]["events"]
    assert [e["kind"] for e in events].count("launch") == 4
    assert rec["extra"]["active_world"] == {"a": [0]}


@pytest.mark.parametrize("pkg", PKGS)
def test_supervisor_gives_up_below_min_slots(pkg):
    el = _supervisor(pkg)
    sup = el.ElasticSupervisor(
        {"a": [0], "b": [0]},
        lambda active, attempt: [("a", _proc("import sys; sys.exit(1)"))],
        probe_fn=lambda h: None,  # everything dies
        policy=el.RestartPolicy(max_restarts=5, min_slots=1,
                                backoff_base_s=0.0),
        sleep_fn=lambda s: None)
    with pytest.raises(el.ElasticGiveUpError, match="min_slots"):
        sup.run()


@pytest.mark.parametrize("pkg", PKGS)
def test_supervisor_probe_resize_changes_slots(pkg):
    el = _supervisor(pkg)
    worlds = []

    def launch(active, attempt):
        worlds.append({h: len(s) for h, s in active.items()})
        return [("a", _proc(
            f"import sys; sys.exit({1 if attempt == 0 else 0})"))]

    sup = el.ElasticSupervisor(
        {"a": [0, 1, 2, 3]}, launch,
        probe_fn=lambda h: [0, 1],  # host survives with half its cards
        policy=el.RestartPolicy(max_restarts=1, backoff_base_s=0.0),
        sleep_fn=lambda s: None)
    assert sup.run() == 0
    assert worlds == [{"a": 4}, {"a": 2}]


@pytest.mark.parametrize("pkg", PKGS)
def test_supervisor_missed_heartbeats_kill_and_restart(pkg, tmp_path):
    """A worker that beats once then hangs: the supervisor declares it
    hung after heartbeat_timeout, kills the attempt, and relaunches."""
    el = _supervisor(pkg)
    hb = tmp_path / "hb"
    hb.mkdir()
    attempts = []

    def launch(active, attempt):
        attempts.append(attempt)
        if attempt == 0:
            code = (
                "import json, time\n"
                "rec = dict(host='h', process_index=0, step=1, "
                "time=time.time(), step_s=0.1)\n"
                f"json.dump(rec, open(r'{hb}/heartbeat_0.json', 'w'))\n"
                "time.sleep(120)\n")
        else:
            code = "pass"
        return [("h", _proc(code))]

    sup = el.ElasticSupervisor(
        {"h": [0]}, launch,
        policy=el.RestartPolicy(max_restarts=1, backoff_base_s=0.0),
        heartbeat_dir=str(hb), heartbeat_timeout_s=0.5,
        poll_interval_s=0.05, term_grace_s=2.0, sleep_fn=lambda s: None)
    t0 = time.time()
    assert sup.run() == 0
    assert attempts == [0, 1]
    assert time.time() - t0 < 60  # killed on staleness, not sleep(120)
    # attempt 0's beat file was swept before attempt 1 launched
    assert _read_heartbeats(pkg, str(hb)) == {}


@pytest.mark.parametrize("pkg", PKGS)
def test_supervisor_exit_skew_stale_beats_do_not_kill(pkg, tmp_path):
    """One worker exits 0 and stops beating while another finishes: the
    finished worker's stale beat is not a hang (no kill, no restart)."""
    el = _supervisor(pkg)
    hb = tmp_path / "hb"
    hb.mkdir()
    attempts = []

    def launch(active, attempt):
        attempts.append(attempt)
        json.dump({"host": "a", "process_index": 0, "step": 5,
                   "time": time.time(), "step_s": 0.1},
                  open(hb / "heartbeat_0.json", "w"))
        return [("a", _proc("pass")),
                ("b", _proc("import time; time.sleep(1.2)"))]

    sup = el.ElasticSupervisor(
        collections.OrderedDict([("a", [0]), ("b", [0])]), launch,
        policy=el.RestartPolicy(max_restarts=2, backoff_base_s=0.0),
        heartbeat_dir=str(hb), heartbeat_timeout_s=0.3,
        poll_interval_s=0.05, sleep_fn=lambda s: None)
    assert sup.run() == 0
    assert attempts == [0]


@pytest.mark.parametrize("pkg", PKGS)
def test_supervisor_remote_kill_fn_called_for_live_hosts(pkg):
    el = _supervisor(pkg)
    cleaned = []

    def launch(active, attempt):
        if attempt == 0:
            return [("a", _proc("import sys; sys.exit(1)")),
                    ("b", _proc("import time; time.sleep(60)"))]
        return [("a", _proc("pass")), ("b", _proc("pass"))]

    sup = el.ElasticSupervisor(
        collections.OrderedDict([("a", [0]), ("b", [0])]), launch,
        policy=el.RestartPolicy(max_restarts=1, backoff_base_s=0.0),
        poll_interval_s=0.05, term_grace_s=2.0,
        sleep_fn=lambda s: None, remote_kill_fn=cleaned.append)
    assert sup.run() == 0
    assert cleaned == ["b"]  # only the live remnant, not the dead "a"


# ---------------------------------------------------------------------------
# end to end: ds_torch --elastic on localhost
# ---------------------------------------------------------------------------
ELASTIC_WORKER = MODEL_SRC + r'''
"""argv: out_dir ckpt_dir total_steps crash_at.  crash_at > 0: on the
first attempt, after step crash_at is checkpointed on every rank, rank 0
hard-exits (3) and the others go on into the next step's collective."""
import json, os, sys
import torch
torch.set_num_threads(1)
import torch.distributed as dist
import deepspeed_tpu_torch as ds
from deepspeed_tpu_torch.runtime.dataloader import (DeepSpeedDataLoader,
                                                    RepeatingLoader)

GLOBAL_BS, DATASET_N = 8, 48  # 6 batches an epoch: resume crosses epochs


def dataset():
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((DATASET_N, HIDDEN)).astype(np.float32)
    # feature 0 IS the sample index: the sample log reads it back
    xs[:, 0] = np.arange(DATASET_N, dtype=np.float32)
    return [(xs[i], (0.5 * xs[i]).astype(np.float32))
            for i in range(DATASET_N)]


out_dir, ckpt_dir = sys.argv[1], sys.argv[2]
total_steps, crash_at = int(sys.argv[3]), int(sys.argv[4])
restart = int(os.environ.get("DS_ELASTIC_RESTART", "0"))
ds.init_distributed(device="cpu")
rank = int(os.environ["RANK"])
assert int(os.environ["WORLD_SIZE"]) == int(
    os.environ.get("DS_ELASTIC_WORLD_SLOTS", os.environ["WORLD_SIZE"]))
engine, *_ = ds.initialize(
    model=ds.FunctionalModule(init, loss), device="cpu",
    config={"train_batch_size": GLOBAL_BS, "gradient_accumulation_steps": 1,
            "steps_per_print": 10 ** 9,
            "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
            "data_prefetch": {"enabled": True, "depth": 2}})
dp = engine.dp_world_size
# every rank collates the global batch: only rank 0 logs its samples
log = open(os.path.join(out_dir, f"samples_r{restart}.jsonl"), "a") \
    if rank == 0 else None


def collate(samples):
    xs = np.stack([s[0] for s in samples])
    if log is not None:
        log.write(json.dumps([int(v) for v in xs[:, 0]]) + "\n")
        log.flush()
    return xs, np.stack([s[1] for s in samples])


engine.training_dataloader = RepeatingLoader(DeepSpeedDataLoader(
    dataset(), batch_size=GLOBAL_BS, collate_fn=collate, shuffle=True,
    seed=5, data_shard=(1, dp, engine.mesh.axis_index("data"))))
engine.load_checkpoint(ckpt_dir)  # the fallback chain; None = fresh
traj = open(os.path.join(out_dir, f"traj_r{restart}.jsonl"), "a") \
    if rank == 0 else None
for step in range(engine.global_steps, total_steps):
    loss_v = float(engine.train_batch())
    engine.save_checkpoint(ckpt_dir)
    if traj is not None:
        traj.write(json.dumps({"step": step, "loss": loss_v, "dp": dp})
                   + "\n")
        traj.flush()
    if crash_at and restart == 0 and step + 1 == crash_at:
        dist.barrier()  # every rank's pieces of the tag are on disk
        if rank == 0:
            os._exit(3)  # hard kill: no close(), prefetched batches die
engine.close()
# no rank tears the group (and rank 0's store under it) down while a
# peer still uses it
dist.barrier()
dist.destroy_process_group()
'''


def _lines(path):
    return [json.loads(line) for line in open(path)]


def _run(tmp_path, name, slots, extra=(), crash_at=0):
    """``ds_torch [--elastic ...]`` over ``localhost slots=<slots>``: the
    run's out dir."""
    script = tmp_path / "elastic_worker.py"
    if not script.exists():
        script.write_text(ELASTIC_WORKER)
    hf = tmp_path / f"hostfile{slots}"
    hf.write_text(f"localhost slots={slots}\n")
    out, ckpt = tmp_path / name, tmp_path / f"{name}_ckpt"
    out.mkdir()
    ckpt.mkdir()
    proc = run_ds_torch(
        ["--hostfile", str(hf), "--launcher", "local", "--master_addr",
         "127.0.0.1", "--master_port", str(free_port()), *extra,
         str(script), str(out), str(ckpt), str(STEPS), str(crash_at)],
        worker_env())
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-4000:])
    return out, proc


ELASTIC = ["--elastic", "--max-restarts", "2", "--backoff-base", "0.1"]


def test_ds_torch_elastic_kill_resume_sample_exact(tmp_path):
    """Rank 0 of 2 hard-exits after step 3; the launcher takes rank 1
    down, the supervisor relaunches at 2 slots, and the stitched run is
    sample-exact and loss-bitwise the uninterrupted run."""
    out, proc = _run(tmp_path, "out", 2, ELASTIC, crash_at=CRASH_AT)
    log = proc.stdout + proc.stderr
    assert "attempt 0 FAILED: worker on localhost exited rc=3" in log
    ref, _ = _run(tmp_path, "ref", 2)
    t = _lines(out / "traj_r0.jsonl") + _lines(out / "traj_r1.jsonl")
    ref_t = _lines(ref / "traj_r0.jsonl")
    assert [r["step"] for r in t] == list(range(STEPS))
    assert [r["dp"] for r in t] == [2] * STEPS
    assert [r["loss"] for r in t] == [r["loss"] for r in ref_t]
    # 3 consumed before the kill (the prefetched extras in the production
    # log are re-produced after the resume, never skipped)
    s = (_lines(out / "samples_r0.jsonl")[:CRASH_AT]
         + _lines(out / "samples_r1.jsonl"))
    assert s[:STEPS] == _lines(ref / "samples_r0.jsonl")[:STEPS]


def test_ds_torch_elastic_resize_matches_dp1_from_start(tmp_path):
    """dp 2 → kill → the probe reports the host at 1 slot → the relaunch
    resumes at dp 1 from the dp-2 checkpoint, with the global loader
    state the dp-2 ranks saved, and matches a dp-1-from-start run."""
    probe = tmp_path / "probe.sh"
    probe.write_text("#!/bin/sh\necho slots=1\n")
    probe.chmod(0o755)
    out, _ = _run(tmp_path, "out", 2,
                  ELASTIC + ["--probe-cmd", f"{probe} {{host}}"],
                  crash_at=CRASH_AT)
    dp1, _ = _run(tmp_path, "dp1", 1)
    t0, t1 = _lines(out / "traj_r0.jsonl"), _lines(out / "traj_r1.jsonl")
    assert [r["dp"] for r in t0] == [2] * CRASH_AT
    assert [r["dp"] for r in t1] == [1] * (STEPS - CRASH_AT)
    assert [r["step"] for r in t0 + t1] == list(range(STEPS))
    ref = _lines(dp1 / "traj_r0.jsonl")
    np.testing.assert_allclose([r["loss"] for r in t0 + t1],
                               [r["loss"] for r in ref], rtol=RESIZE_RTOL)
    s = (_lines(out / "samples_r0.jsonl")[:CRASH_AT]
         + _lines(out / "samples_r1.jsonl"))
    assert s[:STEPS] == _lines(dp1 / "samples_r0.jsonl")[:STEPS]
