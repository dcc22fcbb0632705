"""The host offload tier's CUDA half on the card: the pinned per-leaf D2H
on the side stream, the side-stream uploads and the delayed update's
stash, held against the same tier over host tensors (the path the CPU
tests take).  Marked ``gpu``: each test skips inside itself without a
card.  Run on a machine with one card:

    python -m pytest tests/test_torch_offload_gpu.py -m gpu -q --noconftest

Tolerance: bitwise.  Both arms run the one native Adam on the same fp32
bytes, so the master and moments must agree exactly, and each uploaded
compute copy must equal the host master rounded to bf16 by torch.
"""
import pytest
import torch

from deepspeed_tpu_torch.runtime.offload import (HostOffloadOptimizer,
                                                 StreamingUploader)

pytestmark = pytest.mark.gpu
SHAPES = [(257, 384), (384,), (3, 1000, 64), (1,)]
KW = dict(lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01,
          compute_dtype=torch.bfloat16, use_native=True)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _leaves(seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g) for s in SHAPES]


def _pair(dev):
    master = _leaves(0)
    card = HostOffloadOptimizer([m.to(dev) for m in master], **KW)
    host = HostOffloadOptimizer([m.clone() for m in master], **KW)
    assert card._stream is not None and host._stream is None
    assert all(b.is_pinned() for b in card._grad_bufs + card._up_bufs)
    return card, host


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("pipelined", [True, False])
def test_card_steps_equal_host_steps(dev, pipelined):
    card, host = _pair(dev)
    for step in range(3):
        grads = _leaves(10 + step)
        # written by the compute stream just before the step: the side
        # stream's copies must wait for them
        dgrads = [g.to(dev) * 1.0 for g in grads]
        if pipelined:
            up = StreamingUploader(card.upload)
            card.step(dgrads, on_leaf=up.submit)
            res, timings = up.finish()
            compute = [res[i] for i in range(len(SHAPES))]
            assert len(timings) == len(SHAPES)
        else:
            compute = card.upload_all(card.step(dgrads))
        host.step(grads)
        assert card.last_d2h_bytes == sum(g.numel() * 4 for g in grads)
        assert card.last_d2h_seconds > 0
        assert _same(card.master, host.master), step
        st_c, st_h = card.state_tree(), host.state_tree()
        assert _same(st_c["mu"], st_h["mu"]) and _same(st_c["nu"],
                                                       st_h["nu"])
        for c, m in zip(compute, card.master):
            assert c.is_cuda
            assert torch.equal(c.cpu(), m.to(torch.bfloat16))


def test_delayed_stash_is_the_device_grads(dev):
    card, host = _pair(dev)
    grads = _leaves(20)
    stash = card.pull([g.to(dev) for g in grads])
    assert all(not s.is_cuda and s.is_pinned() for s in stash)
    assert _same(stash, grads)
    assert card.last_d2h_bytes == sum(g.numel() * 4 for g in grads)
    # the stash's own step moves no bytes and keeps the pull's numbers
    seconds = card.last_d2h_seconds
    card.step(stash)
    host.step(grads)
    assert card.last_d2h_seconds == seconds
    assert _same(card.master, host.master)

