"""The block-sparse LUT's native arm (``build_lut(use_native=...)`` over
``csrc/sparse_lut.cpp``, compiled by ``ops/op_builder.py`` into the
library CPU-Adam loads) against its numpy arm and the JAX package's
``build_lut``.

Tolerance: exact — the tables are integers and flags, so the native and
numpy arms, and both packages, must agree element for element (shape,
dtype and values) on random layouts (empty rows and full rows included)
and on the sparsity configs' layouts.
"""
import numpy as np
import pytest

from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as sc
from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import \
    build_lut


def _layouts():
    rng = np.random.default_rng(0)
    out = [rng.random((H, nb, nb)) < p
           for H, nb, p in ((1, 1, 1.0), (2, 5, 0.3), (4, 16, 0.1),
                            (3, 33, 0.5))]
    empty = np.zeros((2, 6, 6), bool)
    empty[1, 2, :] = True          # one full row, every other row empty
    out.append(empty)
    for cfg in (sc.FixedSparsityConfig(num_heads=4, block=16),
                sc.BigBirdSparsityConfig(num_heads=2, block=16),
                sc.BSLongformerSparsityConfig(num_heads=2, block=16)):
        out.append(cfg.make_layout(256))
    return [np.asarray(x, np.int32) for x in out]


def _same(a, b):
    return all(x.dtype == y.dtype and x.shape == y.shape
               and np.array_equal(x, y) for x, y in zip(a, b))


@pytest.fixture
def native():
    try:
        op_builder.load_cpu_ops()
    except op_builder.OpBuilderError as e:
        pytest.skip(f"no host toolchain: {e}")


def test_native_equals_numpy_and_jax(native):
    from deepspeed_tpu.ops.sparse_attention.sparse_self_attention import \
        build_lut as jax_build_lut
    for layout in _layouts():
        mine = build_lut(layout, use_native=True)
        assert mine[0].dtype == np.int32 and mine[1].dtype == bool
        assert _same(mine, build_lut(layout, use_native=False))
        assert _same(mine, jax_build_lut(layout, use_native=True))
        assert _same(mine, jax_build_lut(layout, use_native=False))


def test_the_three_arms(native, monkeypatch):
    """``True`` builds (or raises), ``None`` uses the library only when
    something already loaded it, ``False`` never touches it."""
    layout = _layouts()[2]
    want = build_lut(layout, use_native=False)
    lib = op_builder.cpu_ops_loaded()
    assert lib is not None
    calls = []
    real = lib.ds_build_lut

    def counting(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(lib, "ds_build_lut", counting)
    assert _same(build_lut(layout), want) and len(calls) == 1
    assert _same(build_lut(layout, use_native=False), want)
    assert len(calls) == 1
    # nothing loaded: the default arm stays numpy and builds nothing
    monkeypatch.setattr(op_builder, "_lib", None)

    def no_build():
        raise AssertionError("the default arm must not build")

    monkeypatch.setattr(op_builder, "build_cpu_ops", no_build)
    assert _same(build_lut(layout), want) and len(calls) == 1
    # a failed build: the native arm raises, never a numpy fallback
    monkeypatch.setattr(op_builder, "_compile_error", "g++ not found")
    with pytest.raises(op_builder.OpBuilderError, match="g\\+\\+"):
        build_lut(layout, use_native=True)
