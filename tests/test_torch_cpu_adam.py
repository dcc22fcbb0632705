"""Port parity for the host CPU Adam (``deepspeed_tpu_torch/ops/
cpu_adam.py`` over ``csrc/cpu_adam.cpp``, built by the port's own
``ops/op_builder.py``): against ``deepspeed_tpu.ops.cpu_adam`` on the
same arrays.

Tolerances: bitwise where both packages run the native kernel (the same
C++ source, each package's own build), master, moments and the fused
bf16/fp16 copy; the numpy arms bitwise too; native against numpy within
fp32 1e-6 relative (another order of the same float operations).
"""
import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.cpu_adam import DeepSpeedCPUAdam

SHAPES = [(37,), (16, 24), (3, 5, 7)]


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    params = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[rng.standard_normal(s).astype(np.float32) * 0.1
              for s in SHAPES] for _ in range(4)]
    return params, grads


def _jax_run(params, grads, native, out_dtype, **kw):
    from deepspeed_tpu.ops.cpu_adam import DeepSpeedCPUAdam as JaxAdam
    opt = JaxAdam(use_native=native, **kw)
    p = [x.copy() for x in params]
    outs = None
    for g in grads:
        outs = opt.step(p, g, out_dtype=out_dtype)
    mu = [opt._state[i][0] for i in range(len(p))]
    nu = [opt._state[i][1] for i in range(len(p))]
    lowp = ([np.asarray(o).view(np.uint16) for o in outs]
            if outs is not None else None)
    return p, mu, nu, lowp


def _port_run(params, grads, native, out_dtype, **kw):
    opt = DeepSpeedCPUAdam(use_native=native, **kw)
    p = [torch.from_numpy(x.copy()) for x in params]
    dt = {None: None, "bfloat16": torch.bfloat16,
          "float16": torch.float16}[out_dtype]
    outs = None
    for g in grads:
        outs = [o for _, o in opt.step_leaves(
            p, [torch.from_numpy(x) for x in g], out_dtype=dt)]
    mu = [opt._state[i][0].numpy() for i in range(len(p))]
    nu = [opt._state[i][1].numpy() for i in range(len(p))]
    lowp = ([o.view(torch.int16).numpy().view(np.uint16) for o in outs]
            if dt is not None else None)
    return [x.numpy() for x in p], mu, nu, lowp, opt


def test_native_library_builds_into_the_port():
    lib = op_builder.load_cpu_ops()
    assert lib.ds_cpu_ops_version() == 1
    path = op_builder.build_cpu_ops()
    assert path.parent.name == "_build"
    assert path.parent.parent.name == "deepspeed_tpu_torch"


@pytest.mark.parametrize("out_dtype", [None, "bfloat16", "float16"])
@pytest.mark.parametrize("adamw,wd", [(True, 0.0), (True, 0.01),
                                      (False, 0.01)],
                         ids=["adam", "adamw", "l2"])
@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_matches_jax_cpu_adam_bitwise(out_dtype, adamw, wd, native):
    """Four steps of each arm on both packages: master, moments and the
    fused low-precision copy equal bit for bit."""
    params, grads = _arrays()
    kw = dict(lr=1e-2, betas=(0.9, 0.99), eps=1e-8, weight_decay=wd,
              adamw_mode=adamw)
    jp, jm, jv, jl = _jax_run(params, grads, native, out_dtype, **kw)
    pp, pm, pv, pl, opt = _port_run(params, grads, native, out_dtype, **kw)
    assert opt.is_native is native
    for a, b in zip(pp + pm + pv, jp + jm + jv):
        np.testing.assert_array_equal(a, b)
    if out_dtype is not None:
        for a, b in zip(pl, jl):
            np.testing.assert_array_equal(a, b)


def test_native_against_numpy_arm():
    params, grads = _arrays(1)
    kw = dict(lr=3e-3, weight_decay=0.01)
    a = _port_run(params, grads, True, "bfloat16", **kw)
    b = _port_run(params, grads, False, "bfloat16", **kw)
    for x, y in zip(a[0], b[0]):
        np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-7)


def test_lr_schedule_and_thread_cap():
    """A callable lr takes the applied step count; the OpenMP cap is
    torch's intra-op thread count."""
    seen = []
    opt = DeepSpeedCPUAdam(lr=lambda n: seen.append(n) or 1e-3)
    p = [torch.zeros(8)]
    for _ in range(3):
        list(opt.step_leaves(p, [torch.ones(8)]))
    assert seen == [1, 2, 3]
    assert opt.omp_threads == max(1, min(torch.get_num_threads(),
                                         __import__("os").cpu_count()))


def test_non_float_leaves_pass_through():
    opt = DeepSpeedCPUAdam()
    p = [torch.zeros(4), torch.arange(3)]
    outs = list(opt.step_leaves(p, [torch.ones(4), torch.zeros(3)],
                                out_dtype=torch.bfloat16))
    assert outs[1][1] is p[1] and outs[0][1].dtype == torch.bfloat16
