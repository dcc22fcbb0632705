"""Port parity for parameter streaming (``zero_optimization.
param_streaming`` on the XLA tier with GPT-2's ``stream_scan``;
``runtime/offload_xla.py``'s ``StreamedLeaves``): the counterparts of
``tests/test_param_streaming.py``'s numerics and contract cases.  The
compute copies of the stacked block leaves stay in pinned host memory,
each block fetches its layer, and each layer's gradient goes to a pinned
host stack.  Dryrun leg 10 (ZeRO-3 × streaming on 4 gloo ranks) runs in
``tests/test_torch_offload_xla.py`` with legs 5 and 11.

Tolerances: streaming is a placement, not a change of math: without
clipping (the host stack's norm is summed in another order) losses,
master and the host compute copies equal the unstreamed tier's bit for
bit at fp32, in every composition (grad chunks, the split update, the
delayed update, ZeRO-3 at one rank); with clipping within fp32 1e-6; and
within fp32 1e-5 of the JAX engine's streaming tier (Adam eps 1e-3, the
fp32 configs built at stage 0 with the knobs set after).
"""
import numpy as np
import pytest
import torch

from test_torch_offload_xla import (XLA, batches, bitwise, close, config,
                                    jax_engine, jax_master, masters_close,
                                    port, port_master, run, tree)

STREAM = dict(XLA, param_streaming=True)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny models: one intra-op thread runs them as fast and keeps
    parallel test workers (and the spawned gloo ranks) from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(clip=0.0, steps=4, **extra):
    """The streamed and the unstreamed XLA tier on the same weights and
    batches: (losses, master) of each, and the streamed engine."""
    params = tree("gpt2")
    out = []
    for stream in (True, False):
        zero = dict(STREAM if stream else XLA, **extra)
        eng = port("gpt2", config(clip=clip, **zero), params, stream=stream)
        bs = batches("gpt2", int(eng.train_batch_size), steps=steps)
        losses = run(eng, bs)
        eng._xla_dpu_flush()
        out.append((losses, port_master(eng), eng))
    return out


@pytest.mark.parametrize("extra", [
    {}, {"offload_grad_chunks": 3}, {"offload_split_update": True},
    {"delayed_param_update": True}, {"stage": 3},
    {"offload_grad_chunks": 3, "delayed_param_update": True},
], ids=["fused", "chunks3", "split", "dpu", "zero3", "chunks3_dpu"])
def test_streaming_matches_plain_offload_bitwise(extra):
    """Streaming moves where the block params live: the losses, the fp32
    master and each streamed leaf's host compute copy equal the
    unstreamed tier's, bit for bit, in every composition."""
    (ls, ms, es), (lp, mp, ep) = _pair(**extra)
    assert ls == lp and bitwise(ms, mp)
    st = es._zero.streamer
    assert st is not None and sorted(st.leaves) == [
        i for i, on in enumerate(es._stream_mask) if on]
    for i, host in st.leaves.items():
        assert not host.is_cuda and host.dtype == es.compute_dtype
        assert torch.equal(host, ep._zero.sources[i])
    assert ls[-1] < ls[0]
    es.close()
    ep.close()


def test_streaming_with_clipping_within_fp32():
    """With clipping the host stacks' norm is summed in another order:
    losses and master within 1e-6 of the unstreamed tier."""
    (ls, ms, es), (lp, mp, ep) = _pair(clip=1.0)
    assert close(ls, lp, 1e-6) and masters_close(ms, mp, 1e-6)
    es.close()
    ep.close()


@pytest.mark.parametrize("extra", [
    {}, {"offload_grad_chunks": 3, "offload_split_update": True}],
    ids=["fused", "chunks3_split"])
def test_streaming_matches_jax_streaming_tier(extra):
    """fp32, 3 steps: losses and the final master within 1e-5 of the JAX
    engine's streaming XLA tier."""
    params = tree("gpt2")
    cfg = config(**STREAM, **extra)
    p = port("gpt2", cfg, params, stream=True)
    j = jax_engine("gpt2", cfg, params, stream=True)
    assert any(j._stream_mask)
    bs = batches("gpt2", int(p.train_batch_size))
    assert close(run(p, bs), run(j, bs))
    assert masters_close(port_master(p), jax_master(j, params))
    p.close()
    j.close()


def test_streaming_model_apply_matches_plain_apply():
    """Model level: the ``stream_scan`` model computes the same function
    as the plain one (bitwise) and as the JAX streaming model (fp32
    1e-5)."""
    import jax
    import jax.numpy as jnp
    from test_torch_offload_xla import jax_model, port_model
    from deepspeed_tpu_torch.runtime.utils import params_from_numpy
    params = tree("gpt2")
    tok = np.random.default_rng(0).integers(0, 128, (4, 9), np.int32)
    tp = params_from_numpy(params)
    a = port_model("gpt2", stream=True).apply(tp, torch.from_numpy(tok),
                                              None, train=False)
    b = port_model("gpt2").apply(tp, torch.from_numpy(tok), None,
                                 train=False)
    assert torch.equal(a, b)
    c = jax_model("gpt2", stream=True).apply(
        jax.tree.map(jnp.asarray, params), jnp.asarray(tok),
        jax.random.PRNGKey(0), train=False)
    assert close(a.numpy(), np.asarray(c))


def test_stream_mask_marks_blocks_only():
    """The engine's mask covers exactly the stacked block leaves;
    embeddings and the final LN stay on the device."""
    eng = port("gpt2", config(**STREAM), tree("gpt2"), stream=True)
    names = _names(tree("gpt2"))
    assert len(names) == len(eng._stream_mask)
    for name, m in zip(names, eng._stream_mask):
        assert m == name.startswith("blocks/"), (name, m)
        assert eng._zero.streamed(names.index(name)) == m
    eng.close()


def _names(params, prefix=""):
    out = []
    for k, v in params.items():
        if isinstance(v, dict):
            out += _names(v, f"{prefix}{k}/")
        else:
            out.append(f"{prefix}{k}")
    return out


def test_streaming_contract_refusals():
    """The config refuses streaming without offload and on the host
    tier; the engine refuses a model whose ``streaming_param_spec`` is
    None (no silent unstreamed run) and the partitioning check."""
    from deepspeed_tpu_torch.config import (DeepSpeedConfig,
                                            DeepSpeedConfigError)
    base = {"train_micro_batch_size_per_gpu": 1, "bf16": {"enabled": True},
            "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}
    with pytest.raises(DeepSpeedConfigError, match="param_streaming"):
        DeepSpeedConfig({**base, "zero_optimization": {
            "stage": 2, "param_streaming": True}}, world_size=1)
    with pytest.raises(DeepSpeedConfigError, match="xla-tier"):
        DeepSpeedConfig({**base, "zero_optimization": {
            "stage": 2, "cpu_offload": True, "offload_impl": "host",
            "param_streaming": True}}, world_size=1)
    with pytest.raises(ValueError, match="streaming_param_spec"):
        port("gpt2", config(**STREAM), tree("gpt2"), stream=False)
    # the partitioning check compares device gradients: refused, typed
    eng = port("gpt2", config(**STREAM), tree("gpt2"), stream=True)
    with pytest.raises(NotImplementedError, match="host stacks"):
        eng.verify_gradient_partitioning(batches("gpt2", 4, steps=1)[0])
    eng.close()
