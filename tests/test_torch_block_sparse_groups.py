"""The grouped lookup tables of the tensor-core block-sparse kernels
(``build_group_luts`` in ``deepspeed_tpu_torch/ops/kernels/
block_sparse_attention.py``) against the rows they must reproduce: the JAX
package's ``build_kernel_luts`` (``cols``/``nvalid`` for the forward,
``rows_t``/``nvalid_t`` for dK/dV).

A group is the sparsity blocks one CUDA block owns; it walks the union of
their LUT rows, and a warp skips the entries whose member bit is clear.
So, exactly:
- every query block row, and every key block, is in exactly one group;
- each member's masked union entries are its own JAX row, in order (the
  online softmax then sees the JAX grid's order), and no union entry is
  used by no member;
- dK/dV groups come heaviest first (``nvalid_t`` non-increasing), and the
  Fixed layout at T 4096 packs its 64 global columns into 16 full groups
  of 256 entries per plane.
"""
import numpy as np
import pytest

from deepspeed_tpu.ops.pallas import block_sparse_attention as jbs
from deepspeed_tpu_torch.ops.kernels import block_sparse_attention as bs
from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as sc

from test_torch_zero import one_thread  # noqa: F401

H, T = 4, 1024
BLOCKS = (16, 32, 64, 128)

#: (config, kwargs of the head-uniform layout, kwargs of the per-head one)
CONFIGS = {
    "fixed": ("FixedSparsityConfig", {},
              dict(num_local_blocks=4, num_different_global_patterns=4)),
    "bigbird": ("BigBirdSparsityConfig", dict(num_random_blocks=1),
                dict(num_random_blocks=2, seed=3)),
    "bslongformer": ("BSLongformerSparsityConfig",
                     dict(global_block_indices=[0, 3]),
                     dict(global_block_indices=[1])),
    "variable": ("VariableSparsityConfig",
                 dict(local_window_blocks=[2, 3], global_block_indices=[0]),
                 dict(num_random_blocks=2, local_window_blocks=[2, 3],
                      global_block_indices=[0, 5], seed=5)),
}


def _layout(name, block, per_head):
    cls, uniform, heads = CONFIGS[name]
    kw = dict(heads, different_layout_per_head=True) if per_head else uniform
    return getattr(sc, cls)(num_heads=H, block=block, **kw).make_layout(T)


def _check(layout, block):
    """The three properties of the module docstring, for one layout."""
    cols, nvalid, rows_t, nvalid_t = jbs.build_kernel_luts(layout)
    g = bs.build_group_luts(*bs.build_kernel_luts(layout), block)
    G = bs.group_size(block)
    P, nb = nvalid.shape
    ng = -(-nb // G)
    assert g.fwd_idx.shape[:2] == (P, ng) and g.dkv_keys.shape == (P, ng, G)
    for p in range(P):
        keys = g.dkv_keys[p].ravel()
        # every key block in exactly one group; rows gG + j by construction
        assert sorted(keys[keys >= 0].tolist()) == list(range(nb))
        assert (keys[nb:] == -1).all()
        order = nvalid_t[p][keys[:nb]]
        assert (np.diff(order) <= 0).all(), "dK/dV groups not heaviest first"
        for part, members, ref, ref_n in (
                ("fwd", np.arange(ng * G).reshape(ng, G), cols, nvalid),
                ("dkv", g.dkv_keys[p], rows_t, nvalid_t)):
            idx, mask, count = (getattr(g, f"{part}_{n}")[p]
                                for n in ("idx", "mask", "count"))
            for grp in range(ng):
                n = count[grp]
                u, bits = idx[grp, :n], mask[grp, :n]
                assert (np.diff(u) > 0).all() and (bits != 0).all()
                for j, blk in enumerate(members[grp]):
                    mine = u[(bits >> j) & 1 == 1]
                    if blk < 0 or blk >= nb:
                        assert len(mine) == 0
                        continue
                    want = ref[p, blk, :ref_n[p, blk]]
                    assert np.array_equal(mine, want), (part, grp, j)
    return g


@pytest.mark.parametrize("per_head", [False, True],
                         ids=["uniform", "per_head"])
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_groups_reproduce_the_jax_rows(name, block, per_head):
    layout = _layout(name, block, per_head)
    g = _check(layout, block)
    # one set of tables per LUT plane: per head where the heads differ
    planes = H if (layout != layout[:1]).any() else 1
    assert g.fwd_idx.shape[0] == g.dkv_idx.shape[0] == planes


@pytest.mark.parametrize("block", BLOCKS)
def test_groups_with_an_empty_row_and_column(block):
    """Fixed with query block row 1 and key block column 2 emptied: the
    emptied members use no entry (their kernels write zeros) and the
    emptied key block comes last."""
    layout = _layout("fixed", block, False)
    layout[:, 1, :] = 0
    layout[:, :, 2] = 0
    g = _check(layout, block)
    G = bs.group_size(block)
    assert not (g.fwd_mask[0][1 // G] >> (1 % G) & 1).any()
    keys = g.dkv_keys[0].ravel().tolist()
    grp, j = divmod(keys.index(2), G)
    assert not (g.dkv_mask[0][grp] >> j & 1).any()
    assert keys.index(2) >= int((layout[0].sum(0) > 0).sum())


def test_fixed_4096_global_columns_fill_16_groups():
    """FixedSparsityConfig(num_heads=16) at T 4096, block 16 (the sparse
    phase's layout): the 64 global columns, attended by all 256 query
    block rows, fill the first 16 dK/dV groups with unions of 256 entries
    and full member masks; each forward group is one local window, whose
    four rows share their 67 entries."""
    layout = sc.FixedSparsityConfig(num_heads=16).make_layout(4096)
    g = _check(layout, 16)
    assert g.dkv_count.shape == (1, 64)
    assert (g.dkv_count[0, :16] == 256).all()
    assert (g.dkv_mask[0, :16, :256] == 0b1111).all()
    assert (g.dkv_keys[0, :16] % 4 == 3).all()
    assert (g.dkv_count[0, 16:] < 256).all()
    assert (g.fwd_count[0] == 67).all()
    assert (g.fwd_mask[0, :, :67] == 0b1111).all()


def test_group_tables_refuse_blocks_the_kernels_do_not_take():
    layout = sc.FixedSparsityConfig(num_heads=2, block=8).make_layout(128)
    with pytest.raises(ValueError, match="block"):
        bs.build_group_luts(*bs.build_kernel_luts(layout), 8)
