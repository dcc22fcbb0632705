"""Wall-clock + throughput timers (reference: deepspeed/utils/timer.py;
a port of ``deepspeed_tpu/utils/timer.py``).

``SynchronizedWallClockTimer`` — named timers whose start()/stop() drain
the card first: ``torch.cuda.synchronize`` on every visible CUDA device
(the reference cuda-synchronizes the same way, timer.py:26-103 there).
On a machine without CUDA, as on a CPU engine, there is nothing queued to
drain and the sync does nothing.

``ThroughputTimer`` — samples/sec with warmup-step skip (timer.py:106-183).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from .logging import log_dist


def _synchronize(device=None):
    """Drain outstanding device work: ``torch.cuda.synchronize(d)`` for
    each visible CUDA device, so a timed section bounds the kernels it
    queued on any of them.  Nothing runs when CUDA is absent or when
    ``device`` (the timed engine's) is not a CUDA device.  A device whose
    sync fails does not stop the loop: timing must never kill the
    step."""
    if device is not None and torch.device(device).type != "cuda":
        return
    if not torch.cuda.is_available():
        return
    for i in range(torch.cuda.device_count()):
        try:
            torch.cuda.synchronize(i)
        except Exception:
            pass  # diagnostic path: never let timing kill the step


class _Timer:
    def __init__(self, name: str, device=None):
        self.name = name
        self.device = device
        self.started = False
        self._start = 0.0
        self._elapsed = 0.0

    def start(self):
        assert not self.started, f"timer {self.name} already started"
        _synchronize(self.device)
        self._start = time.time()
        self.started = True

    def stop(self, reset: bool = False):
        assert self.started, f"timer {self.name} not started"
        _synchronize(self.device)
        if reset:
            self._elapsed = time.time() - self._start
        else:
            self._elapsed += time.time() - self._start
        self.started = False

    def reset(self):
        self.started = False
        self._elapsed = 0.0

    def elapsed(self, reset: bool = True) -> float:
        started = self.started
        if started:
            self.stop()
        out = self._elapsed
        if reset:
            self.reset()
        if started:
            self.start()
        return out


class SynchronizedWallClockTimer:
    """Group of named timers with a reference-style ``log``
    (timer.py:74-103).  ``device`` is the timed engine's: a CPU engine's
    timers drain nothing."""

    def __init__(self, device=None):
        self.device = device
        self.timers: Dict[str, _Timer] = {}

    def __call__(self, name: str) -> _Timer:
        if name not in self.timers:
            self.timers[name] = _Timer(name, self.device)
        return self.timers[name]

    @staticmethod
    def memory_usage() -> str:
        from ..runtime.utils import memory_status
        return memory_status()

    def log(self, names: List[str], normalizer: float = 1.0,
            reset: bool = True, ranks: Optional[List[int]] = None):
        assert normalizer > 0.0
        parts = []
        for name in names:
            if name in self.timers:
                ms = self.timers[name].elapsed(reset=reset) * 1000.0
                parts.append(f"{name}: {ms / normalizer:.2f}")
        log_dist("time (ms) | " + " | ".join(parts), ranks=ranks or [0])


class ThroughputTimer:
    """samples/sec across steps, skipping warmup (reference
    timer.py:106-183: start_step counts, epoch bookkeeping trimmed to what
    the engine consumes)."""

    def __init__(self, batch_size: int, num_workers: int = 1,
                 start_step: int = 2, steps_per_output: int = 50,
                 monitor_memory: bool = False, logging_fn=None,
                 device=None):
        self.device = device
        self.batch_size = max(batch_size, 1)
        self.num_workers = num_workers
        self.start_step = start_step
        self.steps_per_output = steps_per_output
        self.monitor_memory = monitor_memory
        self.logging = logging_fn or (lambda msg: log_dist(msg, ranks=[0]))
        self.initialized = False
        self.local_step_count = 0
        self.total_step_count = 0
        self.counted_steps = 0      # steps actually timed (post-warmup)
        self.total_elapsed_time = 0.0
        self._start = 0.0

    def update_epoch_count(self):
        self.local_step_count = 0

    def start(self):
        self.initialized = True
        _synchronize(self.device)
        self._start = time.time()

    def stop(self, report_speed: bool = True):
        if not self.initialized:
            return
        self.local_step_count += 1
        self.total_step_count += 1
        if self.local_step_count < self.start_step:
            return  # warmup steps don't count toward throughput
        _synchronize(self.device)
        self.counted_steps += 1
        self.total_elapsed_time += time.time() - self._start
        if report_speed and \
                self.local_step_count % self.steps_per_output == 0:
            self.logging(
                f"step={self.total_step_count}, "
                f"samples/sec={self.avg_samples_per_sec():.1f}")

    def avg_samples_per_sec(self) -> float:
        # counted_steps survives update_epoch_count: the cumulative elapsed
        # time always divides by the cumulative number of timed steps
        if self.counted_steps <= 0 or self.total_elapsed_time == 0:
            return 0.0
        avg = self.total_elapsed_time / self.counted_steps
        return self.batch_size * self.num_workers / avg
