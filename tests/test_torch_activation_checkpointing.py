"""Port parity for ``deepspeed_tpu_torch.runtime.activation_checkpointing``
against the JAX package's module (the counterparts of
``tests/test_aux.py``'s activation-checkpointing cases): the same blocks
on the same numpy inputs through both packages' ``checkpoint``, values
and gradients within 1e-6 of the largest magnitude;
``cpu_checkpointing`` running the region once with every tensor its
backward saves kept in host memory (the hooks' count); the RNG tracker's
messages and seed scheme; ``configure``'s explicit arguments over the
config block.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.runtime.activation_checkpointing import checkpointing \
    as jac
import deepspeed_tpu_torch
from deepspeed_tpu_torch.runtime.activation_checkpointing import \
    checkpointing as ac

from test_torch_zero import one_thread  # noqa: F401

RTOL = 1e-6


@pytest.fixture(autouse=True)
def fresh():
    """Each test starts and ends unconfigured, in both packages."""
    ac.reset()
    jac.reset()
    ac.offload_stats.clear()
    yield
    ac.reset()
    jac.reset()


def _inputs():
    x = np.random.default_rng(2).standard_normal((4, 8)).astype(np.float32)
    w = np.random.default_rng(3).standard_normal((8, 8)).astype(np.float32)
    return x, w


def _grads(ckpt, block, x, w):
    """``block``'s output through ``ckpt`` and the gradient of
    ``sum(out²)`` with respect to ``w``."""
    tw = torch.tensor(w, requires_grad=True)
    out = ckpt(block, torch.from_numpy(x), tw)
    out.square().sum().backward()
    return out.detach().numpy(), tw.grad.numpy()


def _jax_grads(block, x, w):
    out = jac.checkpoint(block, jnp.asarray(x), jnp.asarray(w))
    g = jax.grad(lambda w: jnp.sum(jac.checkpoint(
        block, jnp.asarray(x), w) ** 2))(jnp.asarray(w))
    return np.asarray(out), np.asarray(g)


def _close(a, b, rtol=RTOL):
    """Within ``rtol`` of ``b``'s largest magnitude (normwise: the two
    frameworks round ``tanh`` and the products' sums differently, and an
    element near zero keeps only the absolute error)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.abs(a - b).max() <= rtol * np.abs(b).max(), (
        np.abs(a - b).max(), np.abs(b).max())


def test_checkpoint_preserves_values_and_grads():
    """``tests/test_aux.py::test_checkpoint_preserves_values_and_grads`` on
    both packages: the checkpointed block equals the plain one and the
    JAX checkpointed block, values and gradients within 1e-6."""
    for mod in (ac, jac):
        mod.configure(deepspeed_config={"activation_checkpointing": {
            "partition_activations": True}})
        assert mod.is_configured()
    x, w = _inputs()
    out, g = _grads(ac.checkpoint, lambda x, w: torch.tanh(x @ w), x, w)
    plain_out, plain_g = _grads(lambda f, *a: f(*a),
                                lambda x, w: torch.tanh(x @ w), x, w)
    jout, jg = _jax_grads(lambda x, w: jnp.tanh(x @ w), x, w)
    _close(out, plain_out)
    _close(g, plain_g)
    _close(out, jout)
    _close(g, jg)
    assert ac._config.partition_activations is True
    ac.reset()
    assert not ac.is_configured()


def _three(x, w, mod=torch):
    for _ in range(3):
        x = mod.tanh(x @ w)
    return x


def test_cpu_checkpointing_keeps_saved_tensors_on_the_host():
    """``cpu_checkpointing`` (``tests/test_aux.py::test_cpu_checkpointing_
    selects_offload_policy``): the region runs once — no recompute — and
    every tensor its backward saves goes through the host-memory hooks
    (packed in the forward, each restored once by the backward); the
    gradients equal the plain block's and the JAX offload policy's within
    1e-6."""
    ac.configure(deepspeed_config={"activation_checkpointing": {
        "cpu_checkpointing": True}})
    jac.configure(deepspeed_config={"activation_checkpointing": {
        "cpu_checkpointing": True}})
    assert jac._policy is not None
    x, w = _inputs()
    calls = []

    def block(x, w):
        calls.append(1)
        return _three(x, w)
    out, g = _grads(ac.checkpoint, block, x, w)
    assert len(calls) == 1, "cpu_checkpointing recomputed the region"
    # what the three products and tanhs save: x and each tanh's output
    # for the products, each tanh's output for its own backward
    saved = ac.offload_stats["tensors"]
    assert saved >= 4, ac.offload_stats
    assert ac.offload_stats["restored"] == saved, ac.offload_stats
    assert ac.offload_stats["bytes"] >= 4 * x.nbytes
    plain_out, plain_g = _grads(lambda f, *a: f(*a), _three, x, w)
    jout, jg = _jax_grads(lambda x, w: _three(x, w, jnp), x, w)
    _close(out, plain_out)
    _close(g, plain_g)
    _close(g, jg)


def test_plain_checkpoint_recomputes_and_saves_nothing_on_the_host():
    """Without ``cpu_checkpointing`` (configured or not) the region is
    recomputed in the backward and the host hooks see nothing."""
    x, w = _inputs()
    for configure in (False, True):
        if configure:
            ac.configure(deepspeed_config={})
        calls = []

        def block(x, w):
            calls.append(1)
            return _three(x, w)
        _grads(ac.checkpoint, block, x, w)
        assert len(calls) == 2
    assert ac.offload_stats["tensors"] == 0


def test_checkpoint_replays_the_rng_in_the_recompute():
    """Dropout inside the region: the recompute draws the forward's mask
    (the reference's saved RNG state), so the gradient equals the plain
    block's under the same seed."""
    x, w = _inputs()

    def block(x, w):
        return torch.nn.functional.dropout(torch.tanh(x @ w), 0.5)
    torch.manual_seed(5)
    out, g = _grads(ac.checkpoint, block, x, w)
    torch.manual_seed(5)
    plain_out, plain_g = _grads(lambda f, *a: f(*a), block, x, w)
    assert (out == 0).any()
    np.testing.assert_array_equal(out, plain_out)
    _close(g, plain_g)


def test_configure_arguments_override_the_block():
    """Explicit arguments over the config block, from a dict or a built
    ``DeepSpeedConfig``, as the JAX module does."""
    from deepspeed_tpu_torch.config import DeepSpeedConfig
    block = {"activation_checkpointing": {"partition_activations": True,
                                          "number_checkpoints": 4}}
    ac.configure(deepspeed_config=block, num_checkpoints=2,
                 checkpoint_in_cpu=True, synchronize=True, profile=True,
                 contiguous_checkpointing=True)
    jac.configure(deepspeed_config=block, num_checkpoints=2,
                  checkpoint_in_cpu=True, synchronize=True, profile=True,
                  contiguous_checkpointing=True)
    names = ("partition_activations", "contiguous_memory_optimization",
             "number_checkpoints", "cpu_checkpointing",
             "synchronize_checkpoint_boundary", "profile")
    assert [getattr(ac._config, n) for n in names] == \
        [getattr(jac._config, n) for n in names] == \
        [True, True, 2, True, True, True]
    ac.reset()
    cfg = DeepSpeedConfig({"train_batch_size": 1, **block})
    ac.configure(deepspeed_config=cfg)
    assert ac._config is cfg.activation_checkpointing_config
    assert ac._config.number_checkpoints == 4
    # configure() with nothing keeps what is configured
    ac.configure(partition_activations=False)
    assert ac._config.partition_activations is False
    assert ac._config.number_checkpoints == 4


def test_rng_tracker_fork_advances():
    """``tests/test_aux.py::test_rng_tracker_fork_advances``: forks of one
    stream differ, and the tracker raises the JAX messages."""
    for mod in (ac, jac):
        tracker = mod.RNGStatesTracker()
        tracker.add("mp", 17)
        k1 = tracker.fork("mp")
        k2 = tracker.fork("mp")
        assert not np.array_equal(np.asarray(k1), np.asarray(k2))
        with pytest.raises(Exception, match="already exists"):
            tracker.add("mp", 1)
        with pytest.raises(Exception, match="not added"):
            tracker.fork("nope")
    # the port's streams are host integers, forked through fold_in
    from deepspeed_tpu_torch.runtime.utils import fold_in
    tracker = ac.RNGStatesTracker()
    tracker.add("mp", 17)
    assert tracker.fork("mp") == fold_in(17, 1)
    assert tracker.get_states() == {"mp": fold_in(17, 0)}
    assert tracker.fork("mp") == fold_in(fold_in(17, 0), 1)
    states = tracker.get_states()
    tracker.reset()
    tracker.set_states(states)
    assert tracker.get_states() == states


@pytest.mark.parametrize("tp_size,tp_rank,pp_rank", [(1, 0, 0), (2, 1, 0),
                                                     (4, 3, 2)])
def test_model_parallel_seed_scheme(tp_size, tp_rank, pp_rank):
    """``tests/test_aux.py::test_model_parallel_seed_ranks_differ`` and the
    reference's scheme: ``seed + 2718 + pp_rank·tp_size + tp_rank`` on both
    packages, the model-parallel stream seeded with it, and tensor-parallel
    ranks differing."""
    s = ac.model_parallel_cuda_manual_seed(1234, tp_rank=tp_rank,
                                           pp_rank=pp_rank, tp_size=tp_size)
    js = jac.model_parallel_cuda_manual_seed(1234, tp_rank=tp_rank,
                                             pp_rank=pp_rank,
                                             tp_size=tp_size)
    assert s == js == 1234 + 2718 + pp_rank * tp_size + tp_rank
    tracker = ac.get_cuda_rng_tracker()
    assert tracker.get_states() == {"model-parallel-rng": s}
    assert s != ac.model_parallel_cuda_manual_seed(
        1234, tp_rank=tp_rank + 1, pp_rank=pp_rank, tp_size=tp_size)


def test_exported_from_the_package():
    """``deepspeed_tpu_torch.checkpointing`` is the module, as
    ``deepspeed_tpu.checkpointing`` is the JAX one; the package exports
    the config class beside it."""
    import deepspeed_tpu
    from deepspeed_tpu_torch.runtime import activation_checkpointing as pkg
    assert deepspeed_tpu_torch.checkpointing is ac
    assert deepspeed_tpu.checkpointing is jac
    assert pkg.DeepSpeedActivationCheckpointingConfig.__name__ == \
        "DeepSpeedActivationCheckpointingConfig"
