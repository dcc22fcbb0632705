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



# ---------------------------------------------------------------------------
# the XLA tier's device ring and the streamed leaves (runtime/offload_xla.py)
# ---------------------------------------------------------------------------
def _ring_case(dev, chunk_bytes):
    """Pinned pieces updated through the ring (several chunks, so both
    slots are reused) against the same math on whole device tensors."""
    from deepspeed_tpu_torch.runtime import offload_xla as ox
    g = torch.Generator().manual_seed(3)
    widths = [70_001, 5, 262_144]
    rows = [torch.randn(w, generator=g) for w in widths]
    pieces = ox.PinnedPieces([r.to(dev) for r in rows], dev, torch.bfloat16,
                             chunk_bytes=chunk_bytes)
    assert all(t.is_pinned() for t in pieces.master + pieces.mu + pieces.nu)
    hp = ox.AdamHyper(0.9, 0.999, 1e-8, 0.01, True)
    ref = [r.to(dev) for r in rows]
    ref_mu = [torch.zeros_like(r) for r in ref]
    ref_nu = [torch.zeros_like(r) for r in ref]
    finite = torch.tensor(True, device=dev)
    lr = torch.tensor(1e-3, device=dev)
    for step in range(1, 4):
        c = torch.tensor(float(step), device=dev)
        c1, c2 = 1 - 0.9 ** c, 1 - 0.999 ** c
        cs = torch.tensor(0.5, device=dev)
        # a device bf16 row, a pinned bf16 row (the chunked grads) and a
        # pinned fp32 stack with its unscale (a streamed leaf)
        gd = torch.randn(widths[0], generator=g).to(dev, torch.bfloat16)
        gh = _pinned_copy(torch.randn(widths[1], generator=g)
                          .to(torch.bfloat16))
        gs = _pinned_copy(torch.randn(widths[2], generator=g))
        inv = torch.tensor(0.25, device=dev)
        sink = _pinned_copy(torch.empty(widths[2], dtype=torch.bfloat16))
        outs = pieces.update([(gd, None), (gh, None), (gs, inv)], finite,
                             c1, c2, lr, cs, hp,
                             sinks=[None, None, sink], in_place=step != 2,
                             timing=True)
        g32 = [gd.float(), gh.to(dev).float(),
               (gs.to(dev) * inv).to(torch.bfloat16).float()]
        for i in range(3):
            ox.PinnedPieces.piece_math(ref[i], ref_mu[i], ref_nu[i], g32[i],
                                       finite, c1, c2, lr, cs, hp)
        pieces.sync()
        for i in range(3):
            assert torch.equal(pieces.master[i], ref[i].cpu()), (step, i)
            assert torch.equal(pieces.mu[i], ref_mu[i].cpu())
            assert torch.equal(pieces.nu[i], ref_nu[i].cpu())
        assert torch.equal(outs[0].cpu(), ref[0].to(torch.bfloat16).cpu())
        assert outs[2] is None
        assert torch.equal(sink, ref[2].to(torch.bfloat16).cpu())
        stats = pieces.transfer_stats()
        assert stats["h2d_bytes"] >= 12 * sum(widths)
        assert stats["h2d_s"] > 0 and stats["window_s"] > 0


def _pinned_copy(t):
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return out.copy_(t)


@pytest.mark.parametrize("chunk_bytes", [1 << 18, 64 << 20],
                         ids=["many_chunks", "one_chunk"])
def test_xla_ring_equals_device_math(dev, chunk_bytes):
    """Bitwise: the ring's events (slot reuse after its D2H), the side
    streams' ``record_stream`` and the pinned sinks change when bytes
    move, not which bytes; the in-place and the swapped (fused) arms
    alike."""
    _ring_case(dev, chunk_bytes)


def test_streamed_leaves_fetch_and_gradient_stack(dev):
    """Layer fetches on the side stream (with the next layer prefetched)
    equal the pinned host slices; gradients written by the compute
    stream just before they are taken to the host land in the stack (the
    first copied, a later micro-batch added)."""
    from deepspeed_tpu_torch.runtime.offload_xla import StreamedLeaves
    host = _pinned_copy(torch.randn(6, 64, 32).to(torch.bfloat16))
    st = StreamedLeaves({0: host}, dev)
    st.fetch_timing = []
    for walk in (range(6), reversed(range(6))):
        for idx in walk:
            got = st.fetch(0, idx)
            assert got.is_cuda and torch.equal(got.cpu(), host[idx])
    stats = st.fetch_stats()
    assert stats["bytes"] >= 12 * host[0].numel() * 2
    assert stats["seconds"] > 0
    g1 = torch.randn(6, 64, 32)
    g2 = torch.randn(6, 64, 32)
    st.begin_step()
    st.start_grads(None)
    for idx in reversed(range(6)):
        st.accumulate(0, idx, g1[idx].to(dev) * 1.0)
    for idx in reversed(range(5)):   # layer 5 reached once only
        st.accumulate(0, idx, g2[idx].to(dev) * 1.0)
    acc = st.finish_grads()[0].acc
    want = g1.clone()
    want[:5] += g2[:5]
    assert torch.equal(acc, want)
