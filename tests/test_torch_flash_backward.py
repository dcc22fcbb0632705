"""Port parity: the gradients of ``deepspeed_tpu_torch``'s flash_attention
(its autograd Function over the plain versions of the forward, dQ and
dK/dV kernels on the CPU) against ``jax.grad`` of the JAX package's Pallas
flash kernel in interpret mode (16-row blocks), on the same numpy inputs
and the same output cotangent.

Tolerances: fp32 1e-5 absolute (same math, other summation order; the
dropout hash is bit-exact, so the dropout cases hold to it too); bf16 1e-2
of the largest gradient magnitude (about 1.5 bf16 ulps at the top of the
range: the Pallas kernels round p and ds to bf16 before their products,
the port keeps them in fp32).
"""
import os
import shutil

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.ops.pallas.flash_attention import (
    dropout_keep_mask as jax_keep_mask,
    flash_attention as jax_flash_attention)
from deepspeed_tpu_torch.ops.kernels import build
from deepspeed_tpu_torch.ops.kernels.flash_attention import (
    dropout_keep_mask, flash_attention, flash_attention_plain,
    flash_bwd_dkv, flash_bwd_dkv_plain, flash_bwd_dq, flash_bwd_dq_plain,
    keep_threshold)

B, H, D = 2, 3, 64
KEY_MASK = np.ones((B, 32), bool)
KEY_MASK[1] = False          # every key of batch row 1 dropped: dead rows
KEY_MASK[0, 7:19] = False


def _inputs(t, tk, seed, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, H, n, D)).astype(np.float32)
            for n in (t, tk, tk, t)]
    if dtype == "bfloat16":  # the same bf16 values on both sides
        arrs = [np.asarray(torch.from_numpy(a).bfloat16().float())
                for a in arrs]
    return arrs


def _grads(t, tk, dtype, **kw):
    """(port grads, JAX grads), each (dq, dk, dv) as fp32 numpy."""
    q, k, v, g = _inputs(t, tk, t + tk, dtype)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16

    def loss(q, k, v):
        out = jax_flash_attention(q, k, v, block_q=16, block_k=16,
                                  interpret=True, **kw)
        return jnp.sum(out.astype(jnp.float32) * g)

    ref = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a, jdt) for a in (q, k, v)))
    ts = [torch.from_numpy(a).to(tdt).requires_grad_(True)
          for a in (q, k, v)]
    out = flash_attention(*ts, **kw)
    (out.float() * torch.from_numpy(g)).sum().backward()
    return ([t_.grad.float().numpy() for t_ in ts],
            [np.asarray(r.astype(jnp.float32)) for r in ref])


CASES = {
    "causal": (40, 40, dict(causal=True)),
    "non-causal cross-length": (24, 56, dict(causal=False)),
    "causal kv_length": (77, 77, dict(causal=True, kv_length=50)),
    "kv_length=0 (all dead)": (24, 56, dict(causal=False, kv_length=0)),
    "key mask with a dead row": (32, 32, dict(causal=False,
                                              key_mask=KEY_MASK)),
    "dropout seed bh_affine": (40, 40, dict(causal=True, dropout_rate=0.25,
                                            dropout_seed=77,
                                            bh_affine=(5, 3, 7))),
    "dropout non-causal key mask": (32, 32, dict(causal=False,
                                                 dropout_rate=0.1,
                                                 dropout_seed=2 ** 32 - 3,
                                                 key_mask=KEY_MASK)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_flash_grads_match_jax_fp32(case):
    t, tk, kw = CASES[case]
    ours, ref = _grads(t, tk, "float32", **kw)
    for name, a, b in zip(("dq", "dk", "dv"), ours, ref):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=name)
    if "kv_length" in kw and kw["kv_length"] == 0:
        assert all((a == 0).all() for a in ours)
    if "key_mask" in kw:  # batch row 1 is dead: exact-zero gradients
        assert all((a[1] == 0).all() for a in ours)


@pytest.mark.parametrize("case", ["causal", "dropout seed bh_affine"])
def test_flash_grads_match_jax_bf16(case):
    t, tk, kw = CASES[case]
    ours, ref = _grads(t, tk, "bfloat16", **kw)
    for name, a, b in zip(("dq", "dk", "dv"), ours, ref):
        assert np.abs(a - b).max() <= 1e-2 * np.abs(b).max(), name


def test_plain_backward_equals_autograd_of_plain_forward():
    """The two backward plain versions are the gradient of the forward's
    plain version (torch autograd through its dense math) — dropout and a
    key mask included."""
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(32, 32, 4,
                                                       "float32"))
    km = torch.where(torch.from_numpy(KEY_MASK), 0.0, -1e9)
    km = km[:, None, :].expand(B, H, 32).reshape(B * H, 32)
    args = (True, 0.125, 30, km, 0.2, 99, (0, B * H, 0))
    qr, kr, vr = (x.clone().requires_grad_(True) for x in (q, k, v))
    out, lse = flash_attention_plain(qr, kr, vr, *args)
    (out * g).sum().backward()
    delta = (g * out.detach()).sum(-1)
    dq = flash_bwd_dq_plain(q, k, v, g, lse.detach(), delta, *args)
    dk, dv = flash_bwd_dkv_plain(q, k, v, g, lse.detach(), delta, *args)
    for ours, ref in ((dq, qr.grad), (dk, kr.grad), (dv, vr.grad)):
        torch.testing.assert_close(ours, ref, atol=1e-5, rtol=1e-5)


def test_keep_threshold_is_the_jax_hash_threshold():
    ids = np.arange(4096, dtype=np.uint32)
    for rate in (0.0, 0.1, 0.5, 1.0 - 2.0 ** -34):
        ref = np.asarray(jax_keep_mask(ids, ids[::-1], 7, 12345, rate))
        ours = dropout_keep_mask(torch.from_numpy(ids.astype(np.int64)),
                                 torch.from_numpy(ids[::-1].astype(np.int64)),
                                 torch.tensor(7), 12345, rate).numpy()
        np.testing.assert_array_equal(ours, ref)
    assert keep_threshold(1.0 - 2.0 ** -34) == 2 ** 32 - 1
    assert keep_threshold(0.1) == round(0.1 * 2 ** 32)


def test_dropout_rng_is_drawn_on_the_host_and_no_cpu_launch_counted():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(16, 16, 1,
                                                       "float32"))
    counts = (flash_attention.launches, flash_bwd_dq.launches,
              flash_bwd_dkv.launches)
    gen = torch.Generator().manual_seed(5)
    seed = int(torch.randint(0, 2 ** 32, (), generator=gen))
    gen.manual_seed(5)
    qr = q.clone().requires_grad_(True)
    a = flash_attention(qr, k, v, dropout_rate=0.3, dropout_rng=gen)
    a.sum().backward()
    b = flash_attention(q, k, v, dropout_rate=0.3, dropout_seed=seed)
    assert torch.equal(a.detach(), b)
    assert (flash_attention.launches, flash_bwd_dq.launches,
            flash_bwd_dkv.launches) == counts


def test_build_digest_covers_included_headers(tmp_path, monkeypatch):
    """An edited csrc/*.cuh header changes the library name of every
    kernel that includes it, so a stale library is never loaded (no nvcc
    needed: only the digest is computed)."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    monkeypatch.setattr(build, "CSRC_DIR", str(csrc))
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
             "decode_attention")
    before = {n: build._target(n)[1] for n in names}
    assert os.path.join(str(csrc), "flash_common.cuh") in \
        build._sources(build._target("flash_bwd_dq")[0])
    with open(csrc / "flash_common.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {n: build._target(n)[1] for n in names}
    # decode_attention includes it through decode_split.cuh
    for n in names:
        assert after[n] != before[n], n
    # a header a kernel does not include leaves its name alone
    with open(csrc / "decode_common.cuh", "a") as f:
        f.write("\n// edited\n")
    again = {n: build._target(n)[1] for n in names}
    for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert again[n] == after[n], n
    assert again["decode_attention"] != after["decode_attention"]
