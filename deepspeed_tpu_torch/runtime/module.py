"""Model protocol consumed by the engine — the port of
``deepspeed_tpu/runtime/module.py``.

A model is a pair (init, loss_fn) over a parameter tree (a dict of
tensors, possibly nested), as in the JAX package:

    class MyModel(TrainModule):
        def init(self, seed, device=None) -> params
        def loss_fn(self, params, batch, rng, train=True) -> scalar loss

``rng`` is a host integer: the engine derives one per (step,
micro-batch) from its seed and counters (``runtime.utils.fold_in``), and
a model derives its dropout seeds from it the same way.  Plain integers
replay exactly when ``torch.utils.checkpoint`` recomputes a block, which
a ``torch.Generator`` carried across the boundary would not.
"""
from __future__ import annotations

from typing import Any, Callable, Optional


class TrainModule:
    """Duck-typed protocol; subclass or just match the surface."""

    def init(self, seed: int, device=None) -> Any:
        raise NotImplementedError

    def loss_fn(self, params, batch, rng, train: bool = True):
        raise NotImplementedError

    def sparse_grad_tokens(self, batch) -> dict:
        """Optional: declare embedding-style params whose gradient rows
        are only the batch's token rows, as ``{keystr: token ids}``.  The
        keystr is the JAX package's (``"['emb']"``, a dict key path as
        ``jax.tree_util.keystr`` writes it), so one declaration serves
        both packages; the ids come from ``batch``, the rank's placed
        ``[grad_acc, micro, ...]`` leaves.  With ``sparse_gradients`` on,
        the engine exchanges these params' gradients over ``data`` as
        (indices, values) instead of dense (``runtime/csr_tensor.py``)."""
        return {}


class FunctionalModule(TrainModule):
    """Wrap bare (init_fn, loss_fn) callables (the JAX package's
    ``FunctionalModule``).  ``init_fn(seed)`` returns the parameter tree
    (numpy or tensors; the engine moves it to its device);
    ``loss_fn(params, batch, rng, train)`` the scalar loss;
    ``partition_spec_fn(params)``, when given, the tree's tensor-parallel
    placement as ``param_partition_specs`` returns it."""

    def __init__(self, init_fn: Callable, loss_fn: Callable,
                 partition_spec_fn: Optional[Callable] = None):
        self._init = init_fn
        self._loss = loss_fn
        self._specs = partition_spec_fn

    def init(self, seed: int, device=None):
        return self._init(seed)

    def loss_fn(self, params, batch, rng, train: bool = True):
        return self._loss(params, batch, rng, train)

    def param_partition_specs(self, params):
        return self._specs(params) if self._specs else None
