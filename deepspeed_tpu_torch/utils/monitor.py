"""Training-scalar monitor (the reference's TensorBoard integration,
reference: deepspeed/runtime/engine.py:253-285,832-843,977-1030; a copy of
``deepspeed_tpu/utils/monitor.py``).

Writes to TensorBoard when the ``tensorboard`` package is importable
(torch ships the writer), else falls back to a JSONL event file with the
same (tag, value, step) triples — the data survives either way and the
engine code has one interface.

Lifecycle-hardened: ``flush()``/``close()`` are idempotent, a post-close
``add_scalar`` drops the point with one warning instead of dying on a
closed file handle, and the writer is a context manager.  The engine
closes its writer on shutdown (``DeepSpeedEngine.close`` + a GC
finalizer) so buffered scalars are never lost.
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional

from .logging import logger


class SummaryWriter:
    def __init__(self, output_path: str = "", job_name: str = "DeepSpeedJobName"):
        base = output_path or os.path.join(os.getcwd(), "runs")
        self.log_dir = os.path.join(base, job_name)
        os.makedirs(self.log_dir, exist_ok=True)
        self._tb = None
        self._jsonl = None
        self._closed = False
        self._warned_closed = False
        try:
            from torch.utils.tensorboard import SummaryWriter as TBWriter
            self._tb = TBWriter(log_dir=self.log_dir)
        except Exception:
            self._jsonl = open(
                os.path.join(self.log_dir, "events.jsonl"), "a")

    @property
    def closed(self) -> bool:
        return self._closed

    def _drop(self, tag: str) -> bool:
        """True when the writer is closed (the point is dropped)."""
        if not self._closed:
            return False
        if not self._warned_closed:
            self._warned_closed = True
            logger.warning(
                "SummaryWriter.add_scalar(%r) after close(): scalar "
                "dropped (further drops are silent)", tag)
        return True

    def add_scalar(self, tag: str, value: float, global_step: int):
        if self._drop(tag):
            return
        if self._tb is not None:
            self._tb.add_scalar(tag, value, global_step)
        else:
            self._jsonl.write(json.dumps(
                {"tag": tag, "value": float(value),
                 "step": int(global_step), "ts": time.time()}) + "\n")

    def flush(self):
        if self._closed:
            return
        if self._tb is not None:
            self._tb.flush()
        else:
            self._jsonl.flush()

    def close(self):
        if self._closed:
            return
        self._closed = True
        if self._tb is not None:
            self._tb.close()
        else:
            self._jsonl.close()

    def __enter__(self) -> "SummaryWriter":
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False
