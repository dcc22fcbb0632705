"""``utils/timer.py`` and ``utils/monitor.py`` of the port against the JAX
package's: both ``ThroughputTimer``s under one fake clock print the same
reports, both ``SummaryWriter`` JSONL files are byte-equal at a fixed
clock, and the port's ``_synchronize`` drains each visible CUDA device
once and does nothing on the CPU."""
import os
import sys

import pytest
import torch

from deepspeed_tpu.utils import monitor as jmonitor
from deepspeed_tpu.utils import timer as jtimer
from deepspeed_tpu_torch.utils import monitor as tmonitor
from deepspeed_tpu_torch.utils import timer as ttimer


@pytest.fixture
def fake_clock(monkeypatch):
    """One clock for both timer modules (each read advances it 0.25 s),
    and no device drain in the timed path."""
    state = {"t": 100.0}

    def now():
        state["t"] += 0.25
        return state["t"]
    for mod in (jtimer, ttimer):
        monkeypatch.setattr(mod.time, "time", now)
        monkeypatch.setattr(mod, "_synchronize", lambda *a: None)
    return state


def _run_throughput(mod, fake_clock, epochs=((5, True), (3, False))):
    fake_clock["t"] = 100.0
    logs = []
    tt = mod.ThroughputTimer(batch_size=8, num_workers=2, start_step=2,
                             steps_per_output=2, logging_fn=logs.append)
    rates = []
    for steps, report in epochs:
        for _ in range(steps):
            tt.start()
            tt.stop(report_speed=report)
            rates.append(tt.avg_samples_per_sec())
        tt.update_epoch_count()
    return logs, rates, (tt.counted_steps, tt.total_step_count,
                         tt.total_elapsed_time)


def test_throughput_timers_print_the_same_reports(fake_clock):
    j = _run_throughput(jtimer, fake_clock)
    t = _run_throughput(ttimer, fake_clock)
    assert j == t
    assert j[0] and all("samples/sec" in line for line in j[0])


def test_wall_clock_timers_log_the_same_line(fake_clock, monkeypatch):
    lines = {}
    for name, mod in (("jax", jtimer), ("torch", ttimer)):
        fake_clock["t"] = 100.0
        got = []
        monkeypatch.setattr(mod, "log_dist",
                            lambda msg, ranks=None, got=got: got.append(msg))
        timers = mod.SynchronizedWallClockTimer()
        for _ in range(3):
            timers("data").start()
            timers("data").stop()
            timers("step").start()
            timers("step").stop()
        timers.log(["data", "step", "absent"], normalizer=3.0)
        lines[name] = got
    assert lines["jax"] == lines["torch"]
    assert lines["torch"] == ["time (ms) | data: 250.00 | step: 250.00"]


def test_summary_writer_files_byte_equal(tmp_path, monkeypatch):
    """The JSONL fallback (TensorBoard's writer made unimportable) of
    both packages at one fixed clock writes the same bytes."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    paths = {}
    for name, mod in (("jax", jmonitor), ("torch", tmonitor)):
        monkeypatch.setattr(mod.time, "time", lambda: 1234.5)
        with mod.SummaryWriter(output_path=str(tmp_path / name),
                               job_name="job") as w:
            for step in range(1, 4):
                w.add_scalar("Train/loss", 1.0 / step, step)
                w.add_scalar("Train/lr", 1e-3, step)
            w.flush()
        w.add_scalar("Train/loss", 9.0, 9)     # after close: dropped
        paths[name] = os.path.join(str(tmp_path / name), "job",
                                   "events.jsonl")
    with open(paths["jax"], "rb") as a, open(paths["torch"], "rb") as b:
        ja, tb = a.read(), b.read()
    assert ja == tb and ja.count(b"\n") == 6


def test_port_summary_writer_lifecycle(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    w = tmonitor.SummaryWriter(output_path=str(tmp_path), job_name="j")
    w.add_scalar("t", 1.0, 1)
    w.flush()
    w.flush()
    w.close()
    w.close()
    assert w.closed
    w.add_scalar("t", 2.0, 2)
    w.flush()
    with open(os.path.join(str(tmp_path), "j", "events.jsonl")) as f:
        assert len(f.readlines()) == 1


@pytest.mark.parametrize("n_dev", [1, 3])
def test_synchronize_drains_each_visible_device_once(monkeypatch, n_dev):
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n_dev)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda d=None: calls.append(d))
    ttimer._synchronize()
    assert calls == list(range(n_dev))
    calls.clear()
    ttimer._synchronize("cuda:0")
    assert calls == list(range(n_dev))
    # a CPU engine's timers drain nothing, even with CUDA present
    calls.clear()
    ttimer._synchronize("cpu")
    timers = ttimer.SynchronizedWallClockTimer(torch.device("cpu"))
    timers("x").start()
    timers("x").stop()
    assert calls == []


def test_synchronize_without_cuda_does_nothing(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda d=None: calls.append(d))
    ttimer._synchronize()
    assert calls == []


def test_synchronize_failure_is_swallowed(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    seen = []

    def boom(d=None):
        seen.append(d)
        raise RuntimeError("device lost")
    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    ttimer._synchronize()        # must not raise, nor stop at device 0
    assert seen == [0, 1]


def test_memory_usage_reads_the_port_memory_line():
    line = ttimer.SynchronizedWallClockTimer.memory_usage()
    assert line.startswith("MEMORY")
