"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``gpu``: each test decides inside itself whether a card is
present and skips without one.  Run on a machine with one card
(``--noconftest``: ``tests/conftest.py`` imports jax, which the card's
machine need not have):

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu -q --noconftest

Tolerances: max abs error 1e-4 in fp32 (same math, other summation
order); 2e-2 in bf16/fp16 (the kernel's output is rounded to the input
type; the plain version runs in fp32 on the same inputs).
"""
import pytest
import torch

from deepspeed_tpu_torch.ops.kernels.decode_attention import (
    _default_scale, decode_attention, decode_attention_cuda,
    decode_attention_plain)
from deepspeed_tpu_torch.ops.kernels.flash_attention import (
    flash_attention, flash_attention_cuda, flash_attention_plain)

pytestmark = pytest.mark.gpu
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16, torch.float16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _randn(dev, *shape, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal,t,tk,kv_length", [
    (True, 512, 512, None), (True, 77, 77, None), (True, 130, 130, 100),
    (False, 64, 200, None), (False, 33, 200, 17), (False, 33, 200, 0),
])
def test_flash_kernel_matches_plain(dev, dtype, causal, t, tk, kv_length):
    q = _randn(dev, 2, 3, t, 64, seed=1).to(dtype)
    k = _randn(dev, 2, 3, tk, 64, seed=2).to(dtype)
    v = _randn(dev, 2, 3, tk, 64, seed=3).to(dtype)
    out, lse = flash_attention_cuda(q, k, v, causal, 0.125, kv_length)
    torch.cuda.synchronize()
    ref, ref_lse = flash_attention_plain(q.float(), k.float(), v.float(),
                                         causal, 0.125, kv_length)
    assert out.dtype == dtype
    assert (out.float() - ref).abs().max().item() <= TOL[dtype]
    assert (lse - ref_lse).abs().max().item() <= TOL[dtype]
    if kv_length == 0:
        assert (out == 0).all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_kernel_matches_plain(dev, dtype):
    S, H, T = 6, 4, 1030
    q = _randn(dev, S, H, 64, seed=4).to(dtype)
    k = _randn(dev, S, H, T, 64, seed=5).to(dtype)
    v = _randn(dev, S, H, T, 64, seed=6).to(dtype)
    lengths = torch.tensor([0, 1, 31, 513, T, 2000], dtype=torch.int32,
                           device=dev)
    out = decode_attention_cuda(q, k, v, lengths, _default_scale(64))
    torch.cuda.synchronize()
    ref = decode_attention_plain(q.float(), k.float(), v.float(), lengths,
                                 _default_scale(64))
    assert (out.float() - ref).abs().max().item() <= TOL[dtype]
    assert (out[0] == 0).all()


def test_public_entry_points_launch_or_raise(dev):
    q = _randn(dev, 1, 2, 16, 64).bfloat16()
    before = flash_attention.launches
    flash_attention(q, q, q)
    assert flash_attention.launches == before + 1
    with pytest.raises(NotImplementedError, match="training"):
        flash_attention(q, q, q, dropout_rate=0.1, dropout_seed=1)
    with pytest.raises(ValueError, match="shapes"):
        flash_attention(q[..., :32], q[..., :32], q[..., :32])
    kc = _randn(dev, 2, 2, 8, 64)
    lengths = torch.tensor([3, 8], device=dev)
    before = decode_attention.launches
    decode_attention(kc[:, :, 0], kc, kc, lengths)
    assert decode_attention.launches == before + 1
    with pytest.raises(ValueError, match="contiguous"):
        decode_attention_cuda(kc[:, :, 0], kc, kc,
                              lengths.to(torch.int32), 0.125)
