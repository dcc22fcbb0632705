"""Data loading — the port of ``deepspeed_tpu/runtime/dataloader.py``.

``DeepSpeedDataLoader`` yields stacked global batches (numpy) from an
indexable dataset; the engine reshapes each into its accumulation layout
and moves it to the card.  ``RepeatingLoader`` restarts an iterable
instead of raising StopIteration.  Both are checkpointable
(``state_dict``/``load_state_dict``): restoring a state makes the next
batch drawn exactly the one the saved loader would have drawn.
"""
from __future__ import annotations

import copy
from typing import Callable, Iterable, Optional

import numpy as np

from ..utils.logging import logger


def supports_iter_state(obj) -> bool:
    """True when ``obj`` carries the checkpointable-iterator protocol."""
    return (callable(getattr(obj, "state_dict", None))
            and callable(getattr(obj, "load_state_dict", None)))


class RepeatingLoader:
    """Wrap an iterable so it restarts instead of raising StopIteration."""

    def __init__(self, loader: Iterable):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            return next(self.data_iter)

    # the repeater holds no position of its own: its state IS the inner
    # loader's state
    def state_dict(self) -> dict:
        if not supports_iter_state(self.loader):
            raise TypeError(
                "RepeatingLoader.state_dict: the wrapped loader "
                f"({type(self.loader).__name__}) has no state_dict/"
                "load_state_dict — sample-exact resume needs a "
                "checkpointable loader (e.g. DeepSpeedDataLoader)")
        return {"loader": self.loader.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        if not supports_iter_state(self.loader):
            raise TypeError(
                "RepeatingLoader.load_state_dict: the wrapped loader "
                f"({type(self.loader).__name__}) is not checkpointable")
        self.loader.load_state_dict(state["loader"])
        self.data_iter = iter(self.loader)


class DeepSpeedDataLoader:
    """Batch iterator over an indexable dataset of dicts/tuples of arrays
    (or arrays), yielding stacked global batches."""

    def __init__(self, dataset, batch_size: int,
                 collate_fn: Optional[Callable] = None,
                 shuffle: bool = False, seed: int = 0,
                 drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn or _default_collate
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)
        self.len = len(dataset) // batch_size
        if not self.drop_last and len(dataset) % batch_size:
            self.len += 1
            # the engine's train_batch rejects a short batch outright
            logger.warning(
                "DeepSpeedDataLoader: drop_last=False with len(dataset)="
                "%d %% batch_size=%d != 0 — the final batch of each "
                "epoch has %d rows instead of %d, which train_batch "
                "refuses. Pad the tail to a full batch or drop it "
                "(drop_last=True).",
                len(dataset), batch_size, len(dataset) % batch_size,
                batch_size)
        # epoch = the epoch being iterated (-1 before the first __iter__);
        # batch_idx = batches produced so far in it (advanced BEFORE each
        # yield); _epoch_rng_state = the RNG state at the epoch's start,
        # from which its shuffle permutation re-derives on resume
        self._epoch = -1
        self._batch_idx = 0
        self._epoch_rng_state = copy.deepcopy(self._rng.bit_generator.state)
        self._resume_idx: Optional[int] = None

    def __len__(self):
        return self.len

    def __iter__(self):
        if self._resume_idx is not None:
            start = self._resume_idx
            self._resume_idx = None
            self._rng.bit_generator.state = copy.deepcopy(
                self._epoch_rng_state)
        else:
            start = 0
            self._epoch += 1
            self._epoch_rng_state = copy.deepcopy(
                self._rng.bit_generator.state)
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        self._batch_idx = start
        for i in range(start, self.len):
            idx = order[i * self.batch_size:(i + 1) * self.batch_size]
            self._batch_idx = i + 1
            yield self.collate_fn([self.dataset[int(j)] for j in idx])

    def state_dict(self) -> dict:
        """JSON-able iteration position."""
        return {
            "version": 1,
            "epoch": int(self._epoch),
            "batch_idx": int(self._batch_idx),
            "rng_state": copy.deepcopy(self._epoch_rng_state),
            "len": int(self.len),
            "shuffle": bool(self.shuffle),
        }

    def load_state_dict(self, state: dict) -> None:
        if int(state.get("len", self.len)) != self.len:
            logger.warning(
                "DeepSpeedDataLoader.load_state_dict: checkpointed "
                "batches/epoch %s != this loader's %s (dataset or batch "
                "size changed) — resuming at the saved batch index "
                "modulo the new epoch length",
                state.get("len"), self.len)
        if bool(state.get("shuffle", self.shuffle)) != self.shuffle:
            logger.warning(
                "DeepSpeedDataLoader.load_state_dict: checkpoint was "
                "taken with shuffle=%s but this loader has shuffle=%s — "
                "the resumed sample order will not match the saved run",
                state.get("shuffle"), self.shuffle)
        self._epoch = int(state["epoch"])
        bi = int(state["batch_idx"])
        if bi > self.len:
            bi = bi % max(self.len, 1)
        self._batch_idx = bi
        self._epoch_rng_state = copy.deepcopy(state["rng_state"])
        self._rng.bit_generator.state = copy.deepcopy(state["rng_state"])
        # epoch -1: the saved loader was never iterated, start fresh
        self._resume_idx = (None if self._epoch < 0
                            else int(self._batch_idx))


def _default_collate(samples):
    first = samples[0]
    if isinstance(first, dict):
        return {k: np.stack([np.asarray(s[k]) for s in samples])
                for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(
            np.stack([np.asarray(s[i]) for s in samples])
            for i in range(len(first)))
    return np.stack([np.asarray(s) for s in samples])
