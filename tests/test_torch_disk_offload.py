"""Port parity for ZeRO-Infinity's disk tier (``offload.tier: "disk"``,
``runtime/disk_offload.py``): the counterparts of
``tests/test_disk_offload.py``'s cases on the port's engine, and the state
files against the JAX package's.

Tolerances: bitwise throughout inside the port — the disk tier runs the
host tier's ``apply_leaf`` on the same bytes, so losses, the fp32 master,
both moments and the uploaded compute copy equal the host tier's, and the
serial loop equals the pipelined one, under transient and sticky faults
and across a kill mid-write-back healed by a checkpoint; the leaf-state
files are byte-equal to the JAX package's for the same leaves, and the
port's fp32 disk tier holds the JAX disk tier's losses within 1e-5.
``tests/test_disk_offload.py::test_bench_offload_tier_smoke`` drives a
JAX benchmark script and has no counterpart here.
"""
import json
import os

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.runtime import disk_offload as dk
from deepspeed_tpu_torch.runtime.stages import reset_fault_injection

from test_torch_offload_xla import batches, close, config, tree

HIDDEN = 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny models: one intra-op thread runs them as fast and keeps
    parallel test workers (and the spawned gloo ranks) from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(tmp_path=None, name="disk", tier="disk", dpu=False, io_depth=2,
         precision="bf16", telemetry=None, steps_per_print=10 ** 9):
    cfg = config(precision, micro=4, ga=1, cpu_offload=True,
                 offload_impl="host", delayed_param_update=dpu)
    cfg["steps_per_print"] = steps_per_print
    if tier == "disk":
        cfg["offload"] = {"tier": "disk", "io_depth": io_depth,
                          "disk_dir": str(tmp_path / f"state_{name}")}
    if telemetry is not None:
        cfg["telemetry"] = {"enabled": True, "output_path": str(telemetry)}
    return cfg


def _engine(cfg, seed=3, nlayers=2):
    from deepspeed_tpu_torch.config import DeepSpeedConfig
    from test_torch_checkpointing import SimpleModel
    eng, *_ = dst.initialize(model=SimpleModel(nlayers=nlayers), seed=seed,
                             device="cpu",
                             config=DeepSpeedConfig(cfg, world_size=1))
    return eng


def _train(eng, steps=4, seed=11):
    return [float(eng.train_batch(b))
            for b in batches("simple", 4, steps=steps, seed=seed)]


def _state(eng):
    """(master, mu, nu, compute copy) as host tensors."""
    ho = eng._host_opt
    st = ho.state_tree()

    def host(xs):
        return [x.materialize() if hasattr(x, "materialize") else x.clone()
                for x in xs]
    return (host(ho.master), host(st["mu"]), host(st["nu"]),
            [s.clone() for s in eng._zero.sources])


def _assert_state_bitwise(a, b):
    for name, xs, ys in zip(("master", "mu", "nu", "compute"), _state(a),
                            _state(b)):
        assert len(xs) == len(ys)
        for i, (x, y) in enumerate(zip(xs, ys)):
            assert x.dtype == y.dtype and torch.equal(x, y), (name, i)


@pytest.fixture(autouse=True)
def _no_fsync(monkeypatch):
    monkeypatch.setenv("DS_DISK_FSYNC", "0")
    monkeypatch.delenv("DS_DISK_OFFLOAD_PIPELINE", raising=False)
    monkeypatch.delenv("DS_STAGE_FAULT", raising=False)
    reset_fault_injection()


# ---------------------------------------------------------------------
# bitwise: disk == host == the serial loop
# ---------------------------------------------------------------------
@pytest.mark.parametrize("dpu", [False, True])
def test_disk_bitwise_equals_host_tier(dpu, tmp_path):
    e_disk = _engine(_cfg(tmp_path, dpu=dpu))
    e_host = _engine(_cfg(tier="host", dpu=dpu))
    assert isinstance(e_disk._host_opt, dk.DiskOffloadOptimizer)
    assert _train(e_disk) == _train(e_host)
    e_disk._dpu_flush()
    e_host._dpu_flush()
    _assert_state_bitwise(e_disk, e_host)
    assert len([f for f in os.listdir(tmp_path / "state_disk")
                if f.endswith(".state")]) == 4
    e_disk.close()
    e_host.close()


def test_disk_pipelined_bitwise_equals_serial(tmp_path, monkeypatch):
    e_pipe = _engine(_cfg(tmp_path, "pipe"), seed=5)
    monkeypatch.setenv("DS_DISK_OFFLOAD_PIPELINE", "0")
    e_ser = _engine(_cfg(tmp_path, "ser"), seed=5)
    l_ser = _train(e_ser)
    monkeypatch.delenv("DS_DISK_OFFLOAD_PIPELINE")
    assert _train(e_pipe) == l_ser
    _assert_state_bitwise(e_pipe, e_ser)
    assert e_ser.last_offload_breakdown["disk_serial"]
    assert not e_pipe.last_offload_breakdown["disk_serial"]
    assert e_ser.last_offload_breakdown["disk_hidden_s"] == 0.0


def test_disk_tier_matches_jax_disk_tier(tmp_path):
    """fp32: the port's disk tier holds the JAX engine's disk tier's
    losses within 1e-5."""
    import jax
    from deepspeed_tpu.config import DeepSpeedConfig
    from deepspeed_tpu.parallel import build_mesh
    from deepspeed_tpu.runtime.engine import DeepSpeedEngine
    from simple_model import SimpleModel as JaxSimple
    from test_torch_offload_xla import built
    cfg = _cfg(tmp_path, "port", precision="fp32")
    jcfg = _cfg(tmp_path, "jax", precision="fp32")
    params = tree("simple")
    p = _engine_fp32(cfg, params)
    jconf = built(DeepSpeedConfig, {k: v for k, v in jcfg.items()
                                    if k != "offload"})
    jconf.offload_config.tier = "disk"
    jconf.offload_config.disk_dir = jcfg["offload"]["disk_dir"]
    jconf.offload_config.io_depth = 2
    j = DeepSpeedEngine(JaxSimple(hidden_dim=HIDDEN), jconf, params=params,
                        seed=3, mesh=build_mesh(dp=1,
                                                devices=jax.devices()[:1]))
    assert j._offload_disk and p._offload_disk
    bs = batches("simple", 4, steps=3)
    got = [float(p.train_batch(b)) for b in bs]
    want = [float(np.asarray(j.train_batch(b))) for b in bs]
    assert close(got, want), (got, want)
    p.close()
    j.close()


def _engine_fp32(cfg, params):
    from deepspeed_tpu_torch.config import DeepSpeedConfig
    from test_torch_checkpointing import SimpleModel
    from test_torch_offload_xla import built
    conf = built(DeepSpeedConfig, {k: v for k, v in cfg.items()
                                   if k != "offload"})
    conf.offload_config.tier = "disk"
    conf.offload_config.disk_dir = cfg["offload"]["disk_dir"]
    conf.offload_config.io_depth = 2
    eng, *_ = dst.initialize(model=SimpleModel(), params=params, seed=3,
                             device="cpu", config=conf)
    return eng


# ---------------------------------------------------------------------
# the fault matrix (DS_STAGE_FAULT, docs/stages.md)
# ---------------------------------------------------------------------
def test_transient_disk_faults_bitwise(tmp_path, monkeypatch):
    e_fault = _engine(_cfg(tmp_path, "fault"), seed=7)
    e_ref = _engine(_cfg(tmp_path, "ref"), seed=7)
    monkeypatch.setenv("DS_STAGE_FAULT",
                       "disk_read:read:2,disk_write:write:3")
    reset_fault_injection()
    l_fault = _train(e_fault)
    monkeypatch.delenv("DS_STAGE_FAULT")
    reset_fault_injection()
    assert l_fault == _train(e_ref)
    _assert_state_bitwise(e_fault, e_ref)
    assert not e_fault._stage_records["disk_read"].degraded
    assert not e_fault._stage_records["disk_write"].degraded
    assert e_fault._stage_records["disk_read"].failures >= 1


@pytest.mark.parametrize("stage,spec", [
    ("disk_read", "disk_read:read:1+"),
    ("disk_write", "disk_write:write:1+")])
def test_sticky_fault_degrades_to_serial_bitwise(stage, spec, tmp_path,
                                                 monkeypatch):
    e_fault = _engine(_cfg(tmp_path, f"sticky_{stage}"), seed=9)
    e_ref = _engine(_cfg(tmp_path, f"sref_{stage}"), seed=9)
    monkeypatch.setenv("DS_STAGE_FAULT", spec)
    reset_fault_injection()
    l_fault = _train(e_fault)
    monkeypatch.delenv("DS_STAGE_FAULT")
    reset_fault_injection()
    assert e_fault._stage_records[stage].degraded
    assert e_fault.last_offload_breakdown["disk_serial"]
    assert l_fault == _train(e_ref)
    _assert_state_bitwise(e_fault, e_ref)


def test_crc_flip_raises_typed_before_state_touched(tmp_path):
    eng = _engine(_cfg(tmp_path, "crc"), seed=11)
    bs = batches("simple", 4, steps=3, seed=2)
    eng.train_batch(bs[0])
    old = list(eng._zero.sources)
    path = eng._host_opt._store.path(0)
    with open(path, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        b = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(dk.DiskStateCorruptError, match="CRC32 mismatch"):
        eng.train_batch(bs[1])
    assert all(a is b for a, b in zip(eng._zero.sources, old))
    assert eng._host_opt._poisoned is not None
    with pytest.raises(RuntimeError, match="poisoned"):
        eng.train_batch(bs[2])
    with pytest.raises(RuntimeError, match="refusing to serialize"):
        eng._host_opt.state_tree()


def test_kill_during_writeback_resumes_from_checkpoint_bitwise(
        tmp_path, monkeypatch):
    bs = batches("simple", 4, steps=4, seed=13)
    e_ref = _engine(_cfg(tmp_path, "kref"), seed=15)
    l_ref = [float(e_ref.train_batch(b)) for b in bs]
    e_vic = _engine(_cfg(tmp_path, "kvic"), seed=15)
    for b in bs[:2]:
        e_vic.train_batch(b)
    e_vic.save_checkpoint(str(tmp_path / "ckpt"), tag="t2",
                          async_write=False)
    real = dk.DiskLeafStore.write
    writes = []

    def dying(self, idx, sections):
        writes.append(idx)
        if len(writes) > 1:
            raise RuntimeError("power cut mid write-back")
        return real(self, idx, sections)

    monkeypatch.setattr(dk.DiskLeafStore, "write", dying)
    with pytest.raises(RuntimeError, match="power cut"):
        e_vic.train_batch(bs[2])
    monkeypatch.undo()
    assert e_vic._host_opt._poisoned is not None
    e_vic.load_checkpoint(str(tmp_path / "ckpt"), tag="t2")
    assert e_vic._host_opt._poisoned is None
    assert [float(e_vic.train_batch(b)) for b in bs[2:]] == l_ref[2:]
    _assert_state_bitwise(e_vic, e_ref)


def test_async_save_downgrades_to_sync(tmp_path):
    eng = _engine(_cfg(tmp_path, "async"), seed=25)
    bs = batches("simple", 4, steps=2, seed=8)
    eng.train_batch(bs[0])
    eng.save_checkpoint(str(tmp_path / "ck"), tag="t1", async_write=True)
    assert not eng._ckpt_writer.in_flight()
    e2 = _engine(_cfg(tmp_path, "async2"), seed=99)
    e2.load_checkpoint(str(tmp_path / "ck"), tag="t1")
    assert float(eng.train_batch(bs[1])) == float(e2.train_batch(bs[1]))


# ---------------------------------------------------------------------
# capacity: state > the RAM budget trains inside its window
# ---------------------------------------------------------------------
def test_capacity_state_exceeds_ram_budget(tmp_path, monkeypatch):
    probe = _engine(_cfg(tmp_path, "probe", io_depth=1), seed=17,
                    nlayers=12)
    opt = probe._host_opt
    biggest = max((3 if prom else 1) * int(np.prod(shape)) * 4
                  for shape, _, prom in opt._meta)
    budget = (2 * opt.io_depth + 3) * biggest
    assert opt.total_state_bytes > budget
    l_probe = _train(probe, steps=2)
    monkeypatch.setenv("DS_OFFLOAD_DISK_RAM_BUDGET_MB",
                       str(budget / (1 << 20)))
    e_cap = _engine(_cfg(tmp_path, "cap", io_depth=1), seed=17, nlayers=12)
    assert _train(e_cap, steps=2) == l_probe
    monkeypatch.delenv("DS_OFFLOAD_DISK_RAM_BUDGET_MB")
    assert e_cap._host_opt.ram_budget_bytes == budget
    assert 0 < e_cap._host_opt.peak_resident_bytes <= budget
    e_host = _engine(_cfg(tier="host"), seed=17, nlayers=12)
    assert _train(e_host, steps=2) == l_probe


def test_budget_violation_raises(tmp_path):
    opt = dk.DiskOffloadOptimizer(
        [torch.ones(64, 64)], lr=1e-2, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=0.0, compute_dtype=torch.bfloat16,
        disk_dir=str(tmp_path / "tiny"), io_depth=1, ram_budget_bytes=1024)
    with pytest.raises(RuntimeError, match="exceeds the configured"):
        opt.step([torch.ones(64, 64)])


# ---------------------------------------------------------------------
# the state files, fsync, the drain order, telemetry
# ---------------------------------------------------------------------
def test_state_files_byte_equal_to_jax_package(tmp_path):
    """The same leaf sections written by both packages' stores are the
    same bytes, and each package reads the other's file (a flipped byte
    is refused by both)."""
    from deepspeed_tpu.runtime import disk_offload as jdk
    rng = np.random.default_rng(0)
    leaves = [{"master": rng.standard_normal((7, 5)).astype(np.float32),
               "mu": rng.standard_normal((7, 5)).astype(np.float32),
               "nu": rng.random((7, 5)).astype(np.float32)},
              {"master": np.arange(6, dtype=np.int32).reshape(2, 3)}]
    mine = dk.DiskLeafStore(str(tmp_path / "port"), fsync=False)
    theirs = jdk.DiskLeafStore(str(tmp_path / "jax"), fsync=False)
    for i, sec in enumerate(leaves):
        mine.write(i, {k: torch.from_numpy(v) for k, v in sec.items()})
        theirs.write(i, sec)
        with open(mine.path(i), "rb") as a, open(theirs.path(i), "rb") as b:
            assert a.read() == b.read(), i
        # each package reads the other's file
        got = dk.DiskLeafStore(str(tmp_path / "jax")).read(
            i, names=tuple(sec))
        back = jdk.DiskLeafStore(str(tmp_path / "port")).read(
            i, names=tuple(sec))
        for k, v in sec.items():
            assert np.array_equal(got[k].numpy(), v)
            assert np.array_equal(back[k], v)
    with open(mine.path(0), "r+b") as f:
        f.seek(-1, os.SEEK_END)
        b = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([b[0] ^ 1]))
    with pytest.raises(dk.DiskStateCorruptError, match="CRC32"):
        mine.read(0)
    os.remove(theirs.path(0))
    with pytest.raises(dk.DiskStateCorruptError, match="missing"):
        dk.DiskLeafStore(str(tmp_path / "jax")).read(0)


def test_fsync_on_by_default(monkeypatch):
    monkeypatch.delenv("DS_DISK_FSYNC", raising=False)
    assert dk.disk_fsync_enabled() is True
    assert dk.disk_fsync_enabled(config_default=False) is False
    monkeypatch.setenv("DS_DISK_FSYNC", "0")
    assert dk.disk_fsync_enabled() is False


def test_drain_order_includes_disk_writeback(tmp_path):
    eng = _engine(_cfg(tmp_path, "drain"), seed=21)
    order = eng._stage_graph.order
    assert (order.index("offload_uploads") < order.index("disk_writeback")
            < order.index("ckpt_writer") < order.index("telemetry"))
    eng.close()


def test_disk_telemetry_reaches_artifacts_and_summarize(tmp_path, capsys):
    """``offload_disk_overlap_ratio`` and the disk byte counters reach
    metrics.prom, the sync scalars reach events.jsonl, and the port's
    ``summarize`` prints the disk tier row."""
    from deepspeed_tpu_torch.telemetry.cli import summarize
    tel = tmp_path / "tel"
    eng = _engine(_cfg(tmp_path, "tel", telemetry=tel, steps_per_print=1),
                  seed=23)
    _train(eng, steps=2)
    assert eng.telemetry.registry.gauge(
        "offload_disk_overlap_ratio").value() is not None
    eng.close()
    prom = (tel / "metrics.prom").read_text()
    for name in ("offload_disk_overlap_ratio", "disk_bytes_read_total",
                 "disk_bytes_written_total"):
        assert name in prom
    syncs = [json.loads(line) for line in
             (tel / "events.jsonl").read_text().splitlines()
             if json.loads(line).get("kind") == "sync"]
    assert any("offload_disk_overlap_ratio" in (s.get("scalars") or {})
               for s in syncs)
    rep = summarize(str(tel / "events.jsonl"))
    assert rep["offload_disk_overlap_ratio"] is not None
    assert rep["disk_read_s"] is not None
    assert "disk tier" in capsys.readouterr().out
