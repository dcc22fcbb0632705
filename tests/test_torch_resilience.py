"""Fault-tolerant checkpointing on the port: the single-process cases of
``tests/test_resilience.py`` run on ``deepspeed_tpu_torch`` (CPU): async
saves bitwise equal to sync and immune to later steps, the writer's
coalescing and failure semantics, CRC / digest / truncation detection,
the corrupt-``latest`` fallback chain and its bound, retention GC and the
orphaned-tmp sweep, ``io_retry``, the kill-at-every-write-point torture
matrix, the drains on a sync save and on close, fsync on by default,
legacy checkpoints without CRCs or without a data plane, and the SIGTERM
preemption hook (resume, config install, mid-step deferral, stacked
handlers, escalation) — plus the data plane's sample-exact resume.

Left out, with what they wait for (ROADMAP.md queue 1):
``test_async_save_bitwise_equals_sync[host_offload]`` and the host-offload
arm of the snapshot test (item 12, offload; the snapshot case runs on the
plain engine, whose master the step updates in place),
``test_pipeline_engine_async_bitwise`` (item 10, pipeline),
``test_async_overlap_visible_in_tracer`` and
``test_ckpt_scalars_flow_to_summarize`` (item 5, telemetry; the retry
case below checks the retry warning in place of the
``ckpt_retries_total`` counter), ``test_bench_ckpt_cpu_smoke`` (the JAX
package's ``bench.py``; the port's counterpart is ``chip_smoke.py``'s
checkpoint phase).
"""
import json
import logging
import os
import shutil
import signal
import threading
import time

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.runtime import checkpointing as ckpt
from deepspeed_tpu_torch.runtime import resilience
from deepspeed_tpu_torch.runtime.dataloader import (DeepSpeedDataLoader,
                                                    RepeatingLoader)
from deepspeed_tpu_torch.runtime.resilience import (
    AsyncCheckpointWriter, CheckpointCorruptError, CheckpointJob,
    RetryPolicy, io_retry, reset_fault_injection)
from deepspeed_tpu_torch.utils.logging import logger as port_logger

from simple_model import random_batches
from test_torch_checkpointing import HIDDEN, _engine, _state_equal, _train


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    for env in ("DS_CKPT_FAULT", "DS_CKPT_DELAY_S", "DS_STAGE_FAULT",
                "DS_STAGE_DELAY_S"):
        monkeypatch.delenv(env, raising=False)
    reset_fault_injection()
    yield
    reset_fault_injection()


def _host(tree):
    return ckpt.tree_map_with_keys(lambda _k, x: x.detach().clone(), tree)


def _dir_bytes(root):
    """relpath -> file bytes for a checkpoint dir (the bitwise contract)."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _same_bytes(a_root, b_root, what):
    a, b = _dir_bytes(a_root), _dir_bytes(b_root)
    assert a.keys() == b.keys()
    for rel in a:
        assert a[rel] == b[rel], f"{rel} {what}"


# ---------------------------------------------------------------------------
# async == sync, bitwise
# ---------------------------------------------------------------------------
def test_async_save_bitwise_equals_sync(tmp_path):
    """Async and sync saves share one serialization path: the artifact
    bytes are identical file for file."""
    eng = _engine()
    _train(eng, steps=2)
    eng.save_checkpoint(str(tmp_path / "sync"), tag="t", async_write=False)
    eng.save_checkpoint(str(tmp_path / "async"), tag="t", async_write=True)
    assert eng._ckpt_writer.drain() is None
    _same_bytes(str(tmp_path / "sync"), str(tmp_path / "async"),
                "differs between sync and async")


def test_async_snapshot_immune_to_later_steps(tmp_path):
    """The snapshot COPIES every leaf to the host: the steps taken while
    the writer is still serializing update the master in place (and on
    the CPU ``.cpu()`` is the live tensor), yet the saved bytes are the
    sync save's at the same step."""
    eng = _engine()
    _train(eng, steps=2)
    eng.save_checkpoint(str(tmp_path / "truth"), tag="t", async_write=False)
    os.environ["DS_CKPT_DELAY_S"] = "0.3"   # the next steps overlap it
    try:
        eng.save_checkpoint(str(tmp_path / "live"), tag="t",
                            async_write=True)
        _train(eng, steps=2, seed=7)
        err = eng._ckpt_writer.drain()
    finally:
        os.environ.pop("DS_CKPT_DELAY_S", None)
    assert err is None
    _same_bytes(str(tmp_path / "truth"), str(tmp_path / "live"),
                "corrupted by post-snapshot steps")


def test_async_roundtrip_restores(tmp_path):
    eng = _engine()
    _train(eng, steps=3)
    eng.save_checkpoint(str(tmp_path), tag="t", async_write=True)
    assert eng._ckpt_writer.drain() is None
    eng2 = _engine(seed=9)
    path, _ = eng2.load_checkpoint(str(tmp_path), tag="t")
    assert path is not None
    _state_equal(eng.state.master_params, eng2.state.master_params)
    assert eng2.global_steps == 3


# ---------------------------------------------------------------------------
# writer semantics
# ---------------------------------------------------------------------------
def test_writer_coalesces_latest_wins(tmp_path):
    ran = []
    gate = threading.Event()

    def slow_job(tag):
        def run():
            if tag == "a":
                gate.wait(5.0)
            ran.append(tag)
        return CheckpointJob(tag=tag, tmp_dir=str(tmp_path / f"{tag}.tmp"),
                             final_dir=str(tmp_path / tag), run=run)

    w = AsyncCheckpointWriter()
    w.submit(slow_job("a"))
    deadline = time.time() + 5.0
    while w._busy is None and time.time() < deadline:
        time.sleep(0.002)
    assert w._busy is not None
    w.submit(slow_job("b"))   # pending
    w.submit(slow_job("c"))   # replaces "b" — latest wins
    assert w.active_tmp() >= {str(tmp_path / "a.tmp"),
                              str(tmp_path / "c.tmp")}
    gate.set()
    assert w.drain() is None
    assert ran == ["a", "c"]
    assert w.coalesced == 1
    w.close()
    w.close()  # idempotent


def test_writer_failure_poisons_only_pending(tmp_path):
    w = AsyncCheckpointWriter()

    def boom():
        raise OSError("disk gone")
    w.submit(CheckpointJob("bad", str(tmp_path / "x.tmp"),
                           str(tmp_path / "x"), boom))
    assert isinstance(w.drain(), OSError)
    assert w.pop_error() is None  # drain cleared it
    ok = []
    w.submit(CheckpointJob("good", str(tmp_path / "y.tmp"),
                           str(tmp_path / "y"), lambda: ok.append(1)))
    assert w.drain() is None
    assert ok == [1]
    assert w.failed == 1 and w.completed == 1
    w.close()


def test_engine_survives_async_save_failure(tmp_path):
    """A writer failure poisons only that save: training continues, the
    error surfaces on the next train_batch (``last_ckpt_error``), and the
    next save succeeds and loads."""
    eng = _engine()
    _train(eng, steps=1)
    os.environ["DS_CKPT_FAULT"] = "meta:1+"
    try:
        eng.save_checkpoint(str(tmp_path), tag="doomed", async_write=True)
        assert eng._ckpt_writer.drain(timeout=10.0) is not None
        eng._ckpt_writer._last_error = OSError("kept for tick")  # rearm
        _train(eng, steps=1, seed=5)  # the pre-step tick surfaces it
    finally:
        os.environ.pop("DS_CKPT_FAULT", None)
    assert isinstance(eng.last_ckpt_error, OSError)
    reset_fault_injection()
    eng.save_checkpoint(str(tmp_path), tag="ok", async_write=True)
    assert eng._ckpt_writer.drain() is None
    path, _ = _engine(seed=3).load_checkpoint(str(tmp_path), tag="ok")
    assert path is not None


# ---------------------------------------------------------------------------
# integrity plane
# ---------------------------------------------------------------------------
def _corrupt_one_leaf(ckpt_dir, plane="model"):
    """Flip bytes inside the first leaf's .npy payload (header intact)."""
    manifest = json.load(open(os.path.join(ckpt_dir, plane,
                                           "manifest.json")))
    key, entry = next((k, e) for k, e in manifest.items()
                      if e.get("nbytes", 0) > 4)
    fpath = os.path.join(ckpt_dir, plane, entry["file"])
    data = bytearray(open(fpath, "rb").read())
    data[-4] ^= 0xFF
    open(fpath, "wb").write(bytes(data))
    return key, entry["file"]


def test_crc_detects_flipped_bit(tmp_path):
    eng = _engine()
    _train(eng, steps=2)
    eng.save_checkpoint(str(tmp_path), tag="t")
    _, fname = _corrupt_one_leaf(str(tmp_path / "t"), "optim")
    eng2 = _engine(seed=9)
    before = _host(eng2.state.master_params)
    with pytest.raises(CheckpointCorruptError) as ei:
        eng2.load_checkpoint(str(tmp_path), tag="t")
    assert fname in str(ei.value) and "CRC32" in str(ei.value)
    # no half-restored state: the engine is untouched and still trains
    _state_equal(before, eng2.state.master_params)
    assert np.isfinite(_train(eng2, steps=1)).all()


def test_manifest_digest_detects_tamper(tmp_path):
    eng = _engine()
    _train(eng, steps=1)
    eng.save_checkpoint(str(tmp_path), tag="t")
    mpath = tmp_path / "t" / "optim" / "manifest.json"
    json.dump(json.load(open(mpath)), open(mpath, "w"), indent=4)
    with pytest.raises(CheckpointCorruptError, match="digest"):
        _engine(seed=1).load_checkpoint(str(tmp_path), tag="t")


def test_truncated_leaf_detected(tmp_path):
    eng = _engine()
    _train(eng, steps=1)
    eng.save_checkpoint(str(tmp_path), tag="t")
    eng2 = _engine(seed=1)
    for plane, module_only in (("optim", False), ("model", True)):
        manifest = json.load(open(tmp_path / "t" / plane / "manifest.json"))
        _, entry = next((k, e) for k, e in manifest.items()
                        if e.get("nbytes", 0) > 16)
        fpath = tmp_path / "t" / plane / entry["file"]
        data = open(fpath, "rb").read()
        open(fpath, "wb").write(data[:-8])  # truncate mid-payload
        with pytest.raises(CheckpointCorruptError):
            eng2.load_checkpoint(str(tmp_path), tag="t",
                                 load_module_only=module_only)


# ---------------------------------------------------------------------------
# fallback chain
# ---------------------------------------------------------------------------
def test_corrupt_latest_falls_back_to_older_tag(tmp_path):
    eng = _engine()
    _train(eng, steps=2)
    eng.save_checkpoint(str(tmp_path), tag="t1")
    good_master = _host(eng.state.master_params)
    _train(eng, steps=1, seed=3)
    eng.save_checkpoint(str(tmp_path), tag="t2")  # latest -> t2
    _corrupt_one_leaf(str(tmp_path / "t2"), "optim")
    eng2 = _engine(seed=9)
    path, _ = eng2.load_checkpoint(str(tmp_path))  # tag=None
    assert path is not None and path.endswith("t1")
    _state_equal(good_master, eng2.state.master_params)
    assert eng2.global_steps == 2


def test_latest_points_to_deleted_tag(tmp_path):
    eng = _engine()
    _train(eng, steps=2)
    eng.save_checkpoint(str(tmp_path), tag="a")
    _train(eng, steps=1, seed=3)
    eng.save_checkpoint(str(tmp_path), tag="b")  # latest -> b
    shutil.rmtree(tmp_path / "b")
    eng2 = _engine(seed=9)
    path, _ = eng2.load_checkpoint(str(tmp_path))
    assert path is not None and path.endswith("a")
    assert eng2.global_steps == 2


def test_fallback_bounded_by_config(tmp_path):
    """load_fallback=0 disables walking back: a corrupt latest raises."""
    over = {"checkpoint": {"load_fallback": 0}}
    eng = _engine(**over)
    _train(eng, steps=1)
    eng.save_checkpoint(str(tmp_path), tag="t1")
    _train(eng, steps=1, seed=3)
    eng.save_checkpoint(str(tmp_path), tag="t2")
    _corrupt_one_leaf(str(tmp_path / "t2"), "optim")
    with pytest.raises(CheckpointCorruptError, match="load_fallback"):
        _engine(seed=9, **over).load_checkpoint(str(tmp_path))


def test_all_candidates_corrupt_raises(tmp_path):
    eng = _engine()
    _train(eng, steps=1)
    eng.save_checkpoint(str(tmp_path), tag="t1")
    _train(eng, steps=1, seed=3)
    eng.save_checkpoint(str(tmp_path), tag="t2")
    _corrupt_one_leaf(str(tmp_path / "t1"), "optim")
    _corrupt_one_leaf(str(tmp_path / "t2"), "optim")
    with pytest.raises(CheckpointCorruptError, match="no loadable"):
        _engine(seed=9).load_checkpoint(str(tmp_path))


# ---------------------------------------------------------------------------
# retention GC + orphan sweep
# ---------------------------------------------------------------------------
def _tag_dirs(root):
    return {d for d in os.listdir(root) if os.path.isdir(root / d)}


def test_retention_keep_last_n(tmp_path):
    over = {"checkpoint": {"keep_last_n": 2}}
    eng = _engine(**over)
    for i in range(4):
        _train(eng, steps=1, seed=i)
        eng.save_checkpoint(str(tmp_path), tag=f"t{i}")
        time.sleep(0.02)  # distinct mtimes for newest-first ordering
    assert _tag_dirs(tmp_path) == {"t2", "t3"}
    assert (tmp_path / "latest").read_text().strip() == "t3"
    path, _ = _engine(seed=9, **over).load_checkpoint(str(tmp_path))
    assert path.endswith("t3")


def test_stale_tmp_sweep(tmp_path):
    """Any save sweeps every orphaned ``*.tmp`` under save_dir."""
    orphan = tmp_path / "dead_tag.tmp"
    orphan.mkdir()
    (orphan / "leaf_00000.npy").write_bytes(b"partial")
    eng = _engine()
    _train(eng, steps=1)
    eng.save_checkpoint(str(tmp_path), tag="fresh")
    assert not orphan.exists()
    assert (tmp_path / "fresh").is_dir()


def test_gc_never_removes_before_save_verifies(tmp_path):
    """A save that dies mid-write must not trigger retention."""
    over = {"checkpoint": {"keep_last_n": 1, "io_retry_attempts": 1}}
    eng = _engine(**over)
    for i in range(2):
        _train(eng, steps=1, seed=i)
        eng.save_checkpoint(str(tmp_path), tag=f"t{i}")
        time.sleep(0.02)
    assert _tag_dirs(tmp_path) == {"t1"}
    _train(eng, steps=1, seed=9)
    os.environ["DS_CKPT_FAULT"] = "meta:1+"
    try:
        with pytest.raises(Exception):
            eng.save_checkpoint(str(tmp_path), tag="t2")
    finally:
        os.environ.pop("DS_CKPT_FAULT", None)
    assert (tmp_path / "t1" / "meta.json").is_file()
    path, _ = _engine(seed=5, **over).load_checkpoint(str(tmp_path))
    assert path.endswith("t1")


# ---------------------------------------------------------------------------
# transient-I/O retry
# ---------------------------------------------------------------------------
def test_io_retry_transient_blip():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("blip")
        return "ok"
    assert io_retry(flaky, "flaky", RetryPolicy(3, 0.001)) == "ok"
    assert len(calls) == 3
    with pytest.raises(OSError):
        io_retry(lambda: (_ for _ in ()).throw(OSError("dead")),
                 "dead", RetryPolicy(2, 0.001))


def test_save_retries_injected_fault(tmp_path, monkeypatch, caplog):
    """A one-shot injected fault (leaf write #2 fails once) is absorbed
    by the retry plane: the save completes, logs its retry, and loads
    back bitwise."""
    monkeypatch.setattr(port_logger, "propagate", True)
    eng = _engine(checkpoint={"io_retry_base_s": 0.001})
    _train(eng, steps=1)
    os.environ["DS_CKPT_FAULT"] = "leaf:2"
    try:
        with caplog.at_level(logging.WARNING, logger=port_logger.name):
            eng.save_checkpoint(str(tmp_path), tag="t")
    finally:
        os.environ.pop("DS_CKPT_FAULT", None)
    assert any("checkpoint I/O retry" in r.getMessage()
               for r in caplog.records)
    eng2 = _engine(seed=5)
    path, _ = eng2.load_checkpoint(str(tmp_path), tag="t")
    assert path is not None
    _state_equal(eng.state.master_params, eng2.state.master_params)
    eng.close()


# ---------------------------------------------------------------------------
# kill-during-save torture matrix
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("point", ["leaf:1+", "leaf:4+", "manifest:1+",
                                   "manifest:2+", "meta:1+", "rename:1+",
                                   "latest:1+"])
def test_torture_kill_at_every_write_point(point, tmp_path):
    """Sustained failure at every write point — each leaf file, the
    manifests, meta.json, the rename, the latest update: a later load
    restores the last GOOD checkpoint bitwise, never a partial one."""
    over = {"checkpoint": {"io_retry_attempts": 2,
                           "io_retry_base_s": 0.001}}
    eng = _engine(**over)
    _train(eng, steps=2)
    eng.save_checkpoint(str(tmp_path), tag="good")
    good_bytes = _dir_bytes(str(tmp_path / "good"))
    good_master = _host(eng.state.master_params)
    good_opt = _host(eng._canonical_state()[1])
    _train(eng, steps=1, seed=7)
    os.environ["DS_CKPT_FAULT"] = point
    try:
        with pytest.raises(Exception):
            eng.save_checkpoint(str(tmp_path), tag="doomed")
        assert not os.path.isfile(
            tmp_path / "doomed" / "meta.json") or point == "latest:1+"
    finally:
        os.environ.pop("DS_CKPT_FAULT", None)
    reset_fault_injection()
    assert _dir_bytes(str(tmp_path / "good")) == good_bytes
    eng2 = _engine(seed=11, **over)
    path, _ = eng2.load_checkpoint(str(tmp_path))  # via latest
    assert path is not None and path.endswith("good")
    _state_equal(good_master, eng2.state.master_params)
    _state_equal(good_opt, eng2._canonical_state()[1])
    assert eng2.global_steps == 2


def test_torture_kill_during_async_save(tmp_path):
    over = {"checkpoint": {"io_retry_attempts": 1}}
    eng = _engine(**over)
    _train(eng, steps=2)
    eng.save_checkpoint(str(tmp_path), tag="good")
    good_master = _host(eng.state.master_params)
    _train(eng, steps=1, seed=7)
    os.environ["DS_CKPT_FAULT"] = "manifest:1+"
    try:
        eng.save_checkpoint(str(tmp_path), tag="doomed", async_write=True)
        err = eng._ckpt_writer.drain()
    finally:
        os.environ.pop("DS_CKPT_FAULT", None)
    assert err is not None  # poisoned THAT save only
    eng2 = _engine(seed=11)
    path, _ = eng2.load_checkpoint(str(tmp_path))
    assert path.endswith("good")
    _state_equal(good_master, eng2.state.master_params)


# ---------------------------------------------------------------------------
# SIGTERM preemption
# ---------------------------------------------------------------------------
def test_preemption_sigterm_resume_identical(tmp_path):
    """SIGTERM mid-run → final sync save + close → restart → a loss
    trajectory bitwise equal to the uninterrupted run's."""
    ref = _engine(seed=0)
    batches = list(random_batches(int(ref.train_batch_size), HIDDEN,
                                  num_batches=5, seed=0))
    ref_losses = [float(ref.train_batch(b)) for b in batches]
    eng = _engine(seed=0)
    handler = resilience.install_preemption_handler(
        eng, str(tmp_path), exit_after=False)
    for b in batches[:3]:
        eng.train_batch(b)
    os.kill(os.getpid(), signal.SIGTERM)
    assert handler.fired
    handler.uninstall()
    eng2 = _engine(seed=42)
    path, _ = eng2.load_checkpoint(str(tmp_path))
    assert path is not None and eng2.global_steps == 3
    assert [float(eng2.train_batch(b)) for b in batches[3:]] \
        == ref_losses[3:]


def test_sigterm_config_installs_handler(tmp_path):
    over = {"checkpoint": {"sigterm_save": True, "save_dir": str(tmp_path)}}
    eng = _engine(**over)
    h = eng._preemption_handler
    assert h is not None and h.installed
    assert signal.getsignal(signal.SIGTERM) == h._handle
    eng.close()  # uninstalls
    assert signal.getsignal(signal.SIGTERM) != h._handle


def test_stacked_handler_uninstall_does_not_clobber(tmp_path):
    """Closing the FIRST of two hooked engines must not clobber the
    second's active handler."""
    e1, e2 = _engine(seed=1), _engine(seed=2)
    h1 = resilience.install_preemption_handler(
        e1, str(tmp_path / "a"), exit_after=False)
    h2 = resilience.install_preemption_handler(
        e2, str(tmp_path / "b"), exit_after=False)
    _train(e1, 1)
    _train(e2, 1)
    h1.uninstall()  # sandwiched: goes inert, does not restore its prev
    assert signal.getsignal(signal.SIGTERM) == h2._handle
    os.kill(os.getpid(), signal.SIGTERM)
    assert h2.fired and not h1.fired
    assert (tmp_path / "b" / "latest").is_file()
    assert not (tmp_path / "a").exists()
    h2.uninstall()
    before = os.listdir(tmp_path)
    os.kill(os.getpid(), signal.SIGTERM)
    assert not h1.fired and os.listdir(tmp_path) == before


def test_sigterm_mid_step_defers_to_boundary(tmp_path):
    """A SIGTERM landing inside train_batch parks; the save runs at the
    step boundary, after the interrupted step finished."""
    eng = _engine(seed=0)
    handler = resilience.install_preemption_handler(
        eng, str(tmp_path), exit_after=False)
    _train(eng, steps=1)
    eng._in_step = True  # the signal lands inside train_batch
    handler._handle(signal.SIGTERM, None)
    assert not handler.fired
    assert eng._deferred_preempt is handler
    assert not (tmp_path / "latest").exists()
    eng._in_step = False
    _train(eng, steps=1, seed=3)  # the finally block completes the save
    assert handler.fired
    assert (tmp_path / "latest").is_file()
    eng2 = _engine(seed=9)
    eng2.load_checkpoint(str(tmp_path))
    assert eng2.global_steps == 2
    handler.uninstall()


def test_sigterm_during_elastic_restart_window_no_double_save(tmp_path):
    """A supervisor's TERM then an escalated TERM: exactly one save on
    disk, the escalation chained to the previous handler."""
    chained = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: chained.append(s))
    try:
        eng = _engine(seed=0)
        handler = resilience.install_preemption_handler(
            eng, str(tmp_path), exit_after=False)
        _train(eng, steps=2)
        os.kill(os.getpid(), signal.SIGTERM)
        assert handler.fired
        assert chained == [signal.SIGTERM]
        latest = (tmp_path / "latest").read_text().strip()
        saved = sorted(os.listdir(tmp_path))
        meta = tmp_path / latest / "meta.json"
        mtime = os.stat(meta).st_mtime_ns
        os.kill(os.getpid(), signal.SIGTERM)
        assert chained == [signal.SIGTERM] * 2
        assert sorted(os.listdir(tmp_path)) == saved
        assert os.stat(meta).st_mtime_ns == mtime
        handler.uninstall()
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_sigterm_escalation_mid_step_defers_one_save(tmp_path):
    eng = _engine(seed=0)
    handler = resilience.install_preemption_handler(
        eng, str(tmp_path), exit_after=False)
    _train(eng, steps=1)
    eng._in_step = True
    handler._handle(signal.SIGTERM, None)
    handler._handle(signal.SIGTERM, None)  # escalation, still mid-step
    assert not handler.fired
    assert not (tmp_path / "latest").exists()
    eng._in_step = False
    _train(eng, steps=1, seed=3)
    assert handler.fired
    eng2 = _engine(seed=9)
    path, _ = eng2.load_checkpoint(str(tmp_path))
    assert path is not None and eng2.global_steps == 2
    handler.uninstall()


# ---------------------------------------------------------------------------
# misc semantics
# ---------------------------------------------------------------------------
def test_sync_save_drains_pending_async(tmp_path):
    """A sync save issued while an async one is in flight lands AFTER
    it — ``latest`` ends on the sync tag."""
    eng = _engine()
    _train(eng, steps=1)
    os.environ["DS_CKPT_DELAY_S"] = "0.2"
    try:
        eng.save_checkpoint(str(tmp_path), tag="a", async_write=True)
    finally:
        os.environ.pop("DS_CKPT_DELAY_S", None)
    eng.save_checkpoint(str(tmp_path), tag="b", async_write=False)
    assert not eng._ckpt_writer.in_flight()
    assert (tmp_path / "a" / "meta.json").is_file()
    assert (tmp_path / "b" / "meta.json").is_file()
    assert (tmp_path / "latest").read_text().strip() == "b"


def test_close_drains_async_save(tmp_path):
    eng = _engine()
    _train(eng, steps=1)
    os.environ["DS_CKPT_DELAY_S"] = "0.2"
    try:
        eng.save_checkpoint(str(tmp_path), tag="t", async_write=True)
    finally:
        os.environ.pop("DS_CKPT_DELAY_S", None)
    eng.close()
    assert (tmp_path / "t" / "meta.json").is_file()


def test_fsync_on_by_default(tmp_path, monkeypatch):
    """Saves fsync every file and the dir unless DS_CKPT_FSYNC=0."""
    calls = []
    real_fsync = os.fsync
    monkeypatch.setattr(os, "fsync", lambda fd: calls.append(fd)
                        or real_fsync(fd))
    eng = _engine()
    _train(eng, steps=1)
    monkeypatch.setenv("DS_CKPT_FSYNC", "0")
    eng.save_checkpoint(str(tmp_path), tag="nosync")
    assert not calls
    monkeypatch.delenv("DS_CKPT_FSYNC")  # the production default: ON
    assert ckpt._fsync_enabled()
    eng.save_checkpoint(str(tmp_path), tag="sync")
    assert len(calls) > 5  # every leaf + manifests + meta + latest + dir


def test_legacy_checkpoint_without_crc_still_loads(tmp_path):
    """Checkpoints without crc32/nbytes/digests load on trust."""
    eng = _engine()
    _train(eng, steps=2)
    eng.save_checkpoint(str(tmp_path), tag="t")
    ck = tmp_path / "t"
    meta = json.load(open(ck / "meta.json"))
    meta.pop("manifest_digests", None)
    meta.pop("format_version", None)
    json.dump(meta, open(ck / "meta.json", "w"))
    for plane in ("model", "optim"):
        mp = ck / plane / "manifest.json"
        m = json.load(open(mp))
        for e in m.values():
            e.pop("crc32", None)
            e.pop("nbytes", None)
        json.dump(m, open(mp, "w"))
    eng2 = _engine(seed=9)
    path, _ = eng2.load_checkpoint(str(tmp_path), tag="t")
    assert path is not None
    _state_equal(eng.state.master_params, eng2.state.master_params)


def test_same_tag_resave_survives_failed_publish(tmp_path):
    """Re-saving an existing tag parks the old copy and restores it when
    the publish rename fails."""
    over = {"checkpoint": {"io_retry_attempts": 1}}
    eng = _engine(**over)
    _train(eng, steps=2)
    eng.save_checkpoint(str(tmp_path), tag="best")
    good = _dir_bytes(str(tmp_path / "best"))
    _train(eng, steps=1, seed=7)
    os.environ["DS_CKPT_FAULT"] = "rename:1+"
    try:
        with pytest.raises(Exception):
            eng.save_checkpoint(str(tmp_path), tag="best")
    finally:
        os.environ.pop("DS_CKPT_FAULT", None)
    reset_fault_injection()
    assert _dir_bytes(str(tmp_path / "best")) == good
    eng2 = _engine(seed=9, **over)
    path, _ = eng2.load_checkpoint(str(tmp_path), tag="best")
    assert path is not None and eng2.global_steps == 2
    eng.save_checkpoint(str(tmp_path), tag="best")
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))


def test_close_surfaces_lost_async_save(tmp_path):
    eng = _engine()
    _train(eng, steps=1)
    os.environ["DS_CKPT_FAULT"] = "meta:1+"
    try:
        eng.save_checkpoint(str(tmp_path), tag="t", async_write=True)
        eng.close()
    finally:
        os.environ.pop("DS_CKPT_FAULT", None)
    assert eng.last_ckpt_error is not None


def test_sweep_restores_stranded_park_dir(tmp_path):
    """A crash between the park and publish renames of a same-tag
    re-save: the next save's sweep RESTORES the parked copy."""
    eng = _engine()
    _train(eng, steps=2)
    eng.save_checkpoint(str(tmp_path), tag="best")
    good = _dir_bytes(str(tmp_path / "best"))
    shutil.move(str(tmp_path / "best"), str(tmp_path / "best.replaced.tmp"))
    (tmp_path / "best.tmp").mkdir()
    (tmp_path / "best.tmp" / "junk.npy").write_bytes(b"partial")
    _train(eng, steps=1, seed=5)
    eng.save_checkpoint(str(tmp_path), tag="other")
    assert _dir_bytes(str(tmp_path / "best")) == good
    assert not (tmp_path / "best.replaced.tmp").exists()
    assert not (tmp_path / "best.tmp").exists()
    eng2 = _engine(seed=9)
    path, _ = eng2.load_checkpoint(str(tmp_path), tag="best")
    assert path is not None and eng2.global_steps == 2


def test_sync_save_surfaces_drained_async_failure(tmp_path):
    """An async save failing while a later sync save drains the writer
    lands in ``last_ckpt_error``."""
    eng = _engine()
    _train(eng, steps=1)
    gate = threading.Event()

    def boom():
        gate.wait(5.0)
        raise OSError("lost async save")
    eng._ckpt_writer.submit(CheckpointJob(
        "doomed", str(tmp_path / "doomed.tmp"),
        str(tmp_path / "doomed"), boom))
    threading.Timer(0.2, gate.set).start()
    eng.save_checkpoint(str(tmp_path), tag="ok", async_write=False)
    assert isinstance(eng.last_ckpt_error, OSError)
    assert (tmp_path / "latest").read_text().strip() == "ok"


def _loader_engine(seed):
    eng = _engine(seed=seed)
    xs = np.random.default_rng(0).standard_normal(
        (32, HIDDEN)).astype(np.float32)
    eng.training_dataloader = RepeatingLoader(DeepSpeedDataLoader(
        [(xs[i], 0.5 * xs[i]) for i in range(32)],
        batch_size=int(eng.train_batch_size), shuffle=True, seed=5))
    return eng


def test_data_plane_resume_is_sample_exact(tmp_path):
    """The data plane carries the shuffled loader's position: a resumed
    engine draws the batches the saved one would have drawn next, so the
    losses continue bitwise."""
    eng = _loader_engine(0)
    for _ in range(3):
        eng.train_batch()
    eng.save_checkpoint(str(tmp_path), tag="t")
    assert (tmp_path / "t" / "data" / "manifest.json").is_file()
    ref = [float(eng.train_batch()) for _ in range(4)]
    eng2 = _loader_engine(9)
    eng2.load_checkpoint(str(tmp_path), tag="t")
    assert [float(eng2.train_batch()) for _ in range(4)] == ref


def test_legacy_checkpoint_without_data_plane_loads_fresh_iter(
        tmp_path, monkeypatch, caplog):
    """A checkpoint without a data plane still loads: the model and
    optimizer restore exactly, the iterator starts fresh with one loud
    warning."""
    eng = _loader_engine(0)
    losses = [float(eng.train_batch()) for _ in range(2)]
    eng.save_checkpoint(str(tmp_path), tag="t")
    eng.close()
    shutil.rmtree(tmp_path / "t" / "data")
    meta = json.load(open(tmp_path / "t" / "meta.json"))
    del meta["manifest_digests"]["data"]
    json.dump(meta, open(tmp_path / "t" / "meta.json", "w"))
    eng2 = _loader_engine(9)
    monkeypatch.setattr(port_logger, "propagate", True)
    with caplog.at_level(logging.WARNING, logger=port_logger.name):
        path, _ = eng2.load_checkpoint(str(tmp_path), tag="t")
    assert path is not None and eng2.global_steps == 2
    assert any("predates the data-iterator plane" in r.getMessage()
               for r in caplog.records)
    _state_equal(eng.state.master_params, eng2.state.master_params)
    float(eng2.train_batch())  # fresh iterator: a replay, not a crash
    assert losses
    eng2.close()


def test_loaded_state_stays_on_the_engine_device(tmp_path):
    """A CPU engine's loaded state stays on the CPU (the port's entry
    points run on the card only unless the caller names a device)."""
    eng = _engine()
    _train(eng, steps=1)
    eng.save_checkpoint(str(tmp_path), tag="t")
    eng2 = _engine(seed=4)
    eng2.load_checkpoint(str(tmp_path), tag="t")
    leaves = [x for _, x in ckpt.tree_flatten_with_keys(
        (eng2.state, eng2._canonical_state()))
        if isinstance(x, torch.Tensor)]
    assert leaves and all(x.device.type == "cpu" for x in leaves)
