"""The port's parallel plumbing against the JAX package's: topology
(``tests/test_topology.py``'s cases on ``deepspeed_tpu_torch.parallel``),
the ZeRO spec rules and plan (``tests/test_zero_specs.py``'s cases, and
GPT-2 small's real leaf shapes at dp 1/2/4/8 × tp 1/2/4 against the JAX
``ZeroShardingPlan``), the mesh's rank layout, the batch row contract,
and the collectives — on a local mesh here and on 2 gloo ranks.

Every comparison here is exact (specs, coordinates, rows); the
collectives on gloo within fp32 1e-6.
"""
import types

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.parallel import (Mesh, ParallelGrid,
                                          PipeDataParallelTopology,
                                          PipeModelDataParallelTopology,
                                          ProcessTopology, build_mesh,
                                          collectives as col,
                                          single_device_mesh)
from deepspeed_tpu_torch.runtime.dataloader import rank_rows
from deepspeed_tpu_torch.runtime.zero import (ZeroRuntime, ZeroShardingPlan,
                                              sanitize_base_spec,
                                              shard_spec_for_leaf)

from test_torch_zero import one_thread  # noqa: F401


def shape_mesh(dp, tp):
    """A (1, dp, 1, tp) mesh with no process groups: its shape is all the
    spec rules read."""
    return Mesh((1, dp, 1, tp), rank=0, groups={})


# ---------------------------------------------------------------------------
# tests/test_topology.py on the port
# ---------------------------------------------------------------------------
def test_topology_2d_ranks():
    topo = ProcessTopology(axes=["row", "col"], dims=[2, 2])
    assert topo.world_size() == 4
    assert [topo.get_rank(row=r, col=c) for r in (0, 1) for c in (0, 1)] \
        == [0, 1, 2, 3]


def test_topology_coords_roundtrip():
    topo = PipeModelDataParallelTopology(num_pp=2, num_mp=2, num_dp=2)
    for r in range(topo.world_size()):
        assert topo.get_rank(**topo.get_coord(r)._asdict()) == r


def test_topology_missing_axis_raises():
    topo = ProcessTopology(axes=["a", "b"], dims=[2, 2])
    with pytest.raises(ValueError):
        topo.get_rank(a=0)


def test_axis_comm_lists():
    topo = PipeDataParallelTopology(num_pp=2, num_dp=4)
    assert topo.get_axis_comm_lists("data") == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert topo.get_axis_comm_lists("pipe") == [[0, 4], [1, 5], [2, 6],
                                                [3, 7]]


def test_filter_match():
    topo = PipeModelDataParallelTopology(num_pp=2, num_mp=2, num_dp=2)
    assert topo.filter_match(pipe=0) == [0, 1, 2, 3]
    assert len(topo.filter_match(pipe=1, model=1)) == 2


def test_rank_repr():
    topo = PipeModelDataParallelTopology(num_pp=2, num_mp=2, num_dp=2)
    r = topo.get_rank(pipe=1, data=0, model=1)
    assert "pipe_01" in topo.get_rank_repr(r)
    assert "model_01" in topo.get_rank_repr(r)
    assert "data" not in topo.get_rank_repr(r)


def test_grid_queries():
    topo = PipeModelDataParallelTopology(num_pp=2, num_mp=2, num_dp=2)
    grid = ParallelGrid(topo, rank=topo.get_rank(pipe=1, data=1, model=0))
    assert (grid.get_pipe_parallel_rank(), grid.get_data_parallel_rank(),
            grid.get_model_parallel_rank()) == (1, 1, 0)
    assert grid.get_slice_parallel_world_size() == 2
    assert grid.is_last_stage() and not grid.is_first_stage()
    nxt = ParallelGrid(PipeDataParallelTopology(num_pp=4, num_dp=2),
                       rank=3).stage_to_global(2)
    assert PipeDataParallelTopology(4, 2).get_coord(nxt).pipe == 2
    assert ParallelGrid(PipeDataParallelTopology(2, 2),
                        rank=0).get_model_parallel_world_size() == 1


def test_topology_copy_matches_jax_package():
    from deepspeed_tpu.parallel import topology as jax_topology
    for dims in ([1, 2, 1, 2], [2, 2, 1, 2], [1, 8, 1, 1]):
        axes = ["pipe", "data", "seq", "model"]
        ours = ProcessTopology(axes, dims)
        ref = jax_topology.ProcessTopology(axes, dims)
        for axis in axes:
            assert ours.get_axis_comm_lists(axis) == \
                ref.get_axis_comm_lists(axis)
        assert [ours.get_rank_repr(r) for r in range(ours.world_size())] \
            == [ref.get_rank_repr(r) for r in range(ref.world_size())]


# ---------------------------------------------------------------------------
# the mesh: rank i holds JAX device i's coordinate
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dp,tp", [(2, 2), (4, 2), (1, 4), (8, 1)])
def test_mesh_coordinates_match_jax_mesh(dp, tp):
    import jax
    from deepspeed_tpu.parallel import build_mesh as jax_build_mesh
    jmesh = jax_build_mesh(dp=dp, tp=tp, devices=jax.devices()[:dp * tp])
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    for rank in range(dp * tp):
        m = Mesh((1, dp, 1, tp), rank=rank, groups={})
        pos = tuple(int(i) for i in np.argwhere(ids == ids.flat[rank])[0])
        assert pos == tuple(m.coord)
        flat = list(ids.flat)
        assert m.axis_ranks("data") == [flat.index(d)
                                        for d in ids[0, :, 0, pos[3]]]
        assert m.axis_ranks("model") == [flat.index(d)
                                         for d in ids[0, pos[1], 0, :]]


def test_local_mesh_and_refusals():
    m = build_mesh()
    assert m.is_local and m.shape == {"pipe": 1, "data": 1, "seq": 1,
                                      "model": 1}
    assert single_device_mesh().group("data") is None
    assert m.group("pipe") is None and m.axis_ranks("pipe") == [0]
    # the pipe and seq axes are ported (items 10 and 11): like any axis
    # they must fit the world, and a local mesh holds one rank
    with pytest.raises(ValueError, match=r"not divisible by pp\*sp\*tp=2"):
        build_mesh(pp=2)
    with pytest.raises(ValueError, match=r"not divisible by pp\*sp\*tp=2"):
        build_mesh(sp=2)
    with pytest.raises(ValueError):
        build_mesh(dp=2)
    with pytest.raises(ValueError, match="one rank"):
        Mesh((1, 2, 1, 1))


# ---------------------------------------------------------------------------
# tests/test_zero_specs.py on the port (a spec is a tuple per dim)
# ---------------------------------------------------------------------------
def test_divisible_entry_kept():
    assert sanitize_base_spec(("data", None), (8, 3), shape_mesh(4, 2)) \
        == ("data", None)


def test_indivisible_entry_dropped():
    assert sanitize_base_spec(("data", None), (6, 3), shape_mesh(4, 2)) \
        == (None, None)


def test_tuple_entry_retains_divisible_major_axes():
    m = shape_mesh(4, 2)
    assert sanitize_base_spec((("data", "model"),), (8,), m) == (
        ("data", "model"),)
    assert sanitize_base_spec((("data", "model"),), (4,), m) == (("data",),)
    # a tuple entry stays a tuple (JAX's P(("model",)) == P("model"))
    assert sanitize_base_spec((("data", "model"),), (2,), m) == (
        ("model",),)
    assert sanitize_base_spec((("data", "model"),), (3,), m) == (None,)


def test_rank_mismatch_raises():
    with pytest.raises(ValueError, match="more entries"):
        sanitize_base_spec(("data", None, None), (4, 4), shape_mesh(4, 2))


def test_shard_spec_first_divisible_dim():
    assert shard_spec_for_leaf((3, 8), 4) == (None, "data")
    assert shard_spec_for_leaf((3, 5), 4) == (None, None)
    assert shard_spec_for_leaf((4,), 1) == (None,)


def test_shard_spec_respects_base():
    assert shard_spec_for_leaf((8, 16), 4, base_spec=("data",)) == (
        "data", None)
    assert shard_spec_for_leaf((8, 16), 4, base_spec=(None, "model")) == (
        "data", "model")


def test_spec_tree_structure_mismatch_raises():
    m = shape_mesh(4, 2)
    params = {"w": np.zeros((8, 4), np.float32),
              "b": np.zeros((4,), np.float32)}
    with pytest.raises(ValueError, match="does not match"):
        ZeroShardingPlan(stage=2, mesh=m, base_param_specs={
            "w": (None, "model")}, params=params)
    with pytest.raises(ValueError, match="does not match"):
        ZeroShardingPlan(stage=2, mesh=m, base_param_specs={
            "w": (None, "model"), "b": (None,), "ghost": ()}, params=params)
    plan = ZeroShardingPlan(stage=2, mesh=m, base_param_specs={
        "w": (None, "model"), "b": (None,)}, params=params)
    assert plan.master_param_specs(params)["w"] == ("data", "model")


def test_spec_leaf_count_mismatch_raises_at_query():
    plan = ZeroShardingPlan(stage=2, mesh=shape_mesh(4, 2),
                            base_param_specs={"w": (None, "model")})
    with pytest.raises(ValueError, match="leaf count"):
        plan.master_param_specs({"w": np.zeros((8, 4), np.float32),
                                 "b": np.zeros((4,), np.float32)})


# ---------------------------------------------------------------------------
# the plan at GPT-2 small's real shapes, against the JAX plan
# ---------------------------------------------------------------------------
def _gpt2_small_shapes():
    """GPT-2 small's leaves as meta tensors, in the port's tree order."""
    import jax
    from deepspeed_tpu.models.gpt2 import GPT2Model as JaxModel
    from deepspeed_tpu_torch.models.gpt2 import GPT2_SMALL, GPT2Model
    abstract = jax.eval_shape(JaxModel(GPT2_SMALL).init,
                              jax.random.PRNGKey(0))

    def build(spec, a):
        if isinstance(spec, dict):
            return {k: build(spec[k], a[k]) for k in spec}
        return torch.empty(a.shape, device="meta")
    return build(GPT2Model(GPT2_SMALL).param_partition_specs(None),
                 abstract)


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("dp", [1, 2, 4, 8])
def test_gpt2_small_plan_matches_jax_plan(dp, tp):
    """Every stage's master, compute and grad specs of GPT-2 small's 16
    leaves equal the JAX plan's (the JAX plan reads only the mesh's
    shape); the placements put the stacked leaves' ZeRO dim on L where 12
    divides and ``wte``'s on d, and ``wte`` stays replicated over
    ``model`` (50257 does not divide) while the Megatron leaves split."""
    from jax.sharding import PartitionSpec as P
    from deepspeed_tpu.models.gpt2 import GPT2Model as JaxModel
    from deepspeed_tpu.runtime.zero import ZeroShardingPlan as JaxPlan
    from deepspeed_tpu_torch.models.gpt2 import GPT2_SMALL, GPT2Model
    params = _gpt2_small_shapes()
    jspecs = JaxModel(GPT2_SMALL).param_partition_specs(None)
    jmesh = types.SimpleNamespace(shape={"pipe": 1, "data": dp, "seq": 1,
                                         "model": tp})
    mesh = shape_mesh(dp, tp)
    def spec_leaves(tree):
        if isinstance(tree, dict):
            return [x for v in tree.values() for x in spec_leaves(v)]
        return [tree]
    for stage in (0, 1, 2, 3):
        ours = ZeroShardingPlan(stage, mesh,
                                GPT2Model(GPT2_SMALL).param_partition_specs(
                                    params), params=params)
        ref = JaxPlan(stage, jmesh, jspecs, params=params)
        for q in ("master_param_specs", "compute_param_specs",
                  "grad_specs"):
            got = spec_leaves(getattr(ours, q)(params))
            import jax
            want = jax.tree.leaves(getattr(ref, q)(params),
                                   is_leaf=lambda x: isinstance(x, P))
            # the port walks dict insertion order, JAX sorted keys
            order = sorted(range(len(got)), key=lambda i: _names()[i])
            assert [got[i] for i in order] == [tuple(w) for w in want], \
                (stage, q)
    pl = dict(zip(_names(), ours.placements(params)))
    if tp == 1:
        assert (pl["wte"].tp_dim, pl["wte"].zero_dim) == (0, 1)
    else:       # 50257 rows do not divide: wte stays whole over model
        assert (pl["wte"].tp_dim, pl["wte"].zero_dim) == (
            None, 0 if dp == 1 else 1)
    assert pl["blocks/qkv_w"].tp_dim == 3
    assert pl["blocks/qkv_w"].zero_dim == (0 if 12 % dp == 0 else 1)


def _names():
    from deepspeed_tpu_torch.models.gpt2 import GPT2_SMALL, GPT2Model
    out = []
    for k, v in GPT2Model(GPT2_SMALL).param_partition_specs(None).items():
        out += ([f"{k}/{n}" for n in v] if isinstance(v, dict) else [k])
    return out


def test_one_rank_runs_the_same_slicing():
    """At dp 1 the specs shard nothing, yet the runtime's ZeRO dims are
    chosen by the same rule (so stage 3 at one rank gathers as many ranks
    do); every box is the whole leaf."""
    params = {"w": torch.zeros(4, 6), "b": torch.zeros(6),
              "s": torch.zeros(())}
    plan = ZeroShardingPlan(3, single_device_mesh(), params=params)
    rt = ZeroRuntime(plan, params, torch.float32)
    assert [p.zero_dim for p in rt.placements] == [0, 0, None]
    assert all(rt.box(i, True) == tuple((0, n) for n in p.shape)
               for i, p in enumerate(rt.placements))
    assert plan.master_param_specs(params) == {"w": (None, None),
                                               "b": (None,), "s": ()}


# ---------------------------------------------------------------------------
# the batch contract: rank d feeds the rows JAX places on data index d
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dp", [2, 4])
def test_rank_rows_are_the_jax_engines_rows(dp):
    import jax
    from deepspeed_tpu.config import DeepSpeedConfig
    from deepspeed_tpu.parallel import build_mesh as jax_build_mesh
    from deepspeed_tpu.runtime.engine import DeepSpeedEngine
    from simple_model import SimpleModel, base_config
    ga, mb = 3, 2
    eng = DeepSpeedEngine(
        SimpleModel(hidden_dim=4),
        DeepSpeedConfig(base_config(micro_bs=mb, grad_acc=ga),
                        world_size=dp),
        mesh=jax_build_mesh(dp=dp, devices=jax.devices()[:dp]))
    x = np.arange(ga * mb * dp * 4, dtype=np.float32).reshape(-1, 4)
    placed = eng._shard_batch((x, x))[0]           # [ga, dp*mb, 4]
    for shard in placed.addressable_shards:
        d = shard.index[1].start // mb
        want = np.asarray(shard.data)               # [ga, mb, 4]
        got = rank_rows(x, ga, dp, d).reshape(ga, mb, 4)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, x.reshape(ga, dp, mb, 4)[:, d])


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
def test_collectives_on_a_local_mesh_are_one_rank_results():
    m = single_device_mesh()
    x = torch.arange(6.0).reshape(2, 3).requires_grad_(True)
    for fn in (col.psum, col.pmean, col.pmax):
        assert torch.equal(fn(x.detach(), m, "data"), x.detach())
    assert torch.equal(col.all_gather(x.detach(), m, "data", 1), x)
    assert torch.equal(col.reduce_scatter(x.detach(), m, "data", 1), x)
    assert torch.equal(col.pbroadcast_from(x.detach(), m, "data"), x)
    assert torch.equal(col.reduce_to(x.detach(), m, "data"), x)
    for pair in (col.copy_to_axis, col.reduce_from_axis):
        g, = torch.autograd.grad((pair(x, m, "model") * 2).sum(), x)
        assert torch.equal(g, torch.full_like(x, 2.0))
    g, = torch.autograd.grad(
        (col.gather_from_axis(x, m, "data", 1) * 3).sum(), x)
    assert torch.equal(g, torch.full_like(x, 3.0))


def _collectives_on_ranks(rank, world):
    from deepspeed_tpu_torch.parallel import build_mesh as bm
    m = bm(dp=world)
    x = torch.arange(6.0).reshape(2, 3) + 10 * rank
    out = {"psum": col.psum(x, m, "data"), "pmean": col.pmean(x, m, "data"),
           "pmax": col.pmax(x, m, "data"),
           "gather1": col.all_gather(x, m, "data", 1),
           "scatter1": col.reduce_scatter(
               torch.arange(8.0).reshape(2, 4) * (rank + 1), m, "data", 1),
           "bcast": col.pbroadcast_from(x, m, "data", root=1),
           "reduce": col.reduce_to(x, m, "data", root=0)}
    w = x.clone().requires_grad_(True)
    loss = (col.copy_to_axis(w, m, "data") * (rank + 1)).sum()
    out["copy_grad"], = torch.autograd.grad(loss, w)
    w = x.clone().requires_grad_(True)
    y = col.reduce_from_axis(w, m, "data")
    out["reduce_fwd"] = y.detach()
    out["reduce_grad"], = torch.autograd.grad((y * (rank + 1)).sum(), w)
    w = x.clone().requires_grad_(True)
    y = col.gather_from_axis(w, m, "data", 0)
    out["gather_fwd"] = y.detach()
    out["gather_grad"], = torch.autograd.grad((y * (rank + 1)).sum(), w)
    return out


def test_collectives_on_two_gloo_ranks(tmp_path):
    from test_torch_zero import spawn_ranks
    res = spawn_ranks(_collectives_on_ranks, 2, tmp_path)
    x = [torch.arange(6.0).reshape(2, 3) + 10 * r for r in range(2)]
    s = torch.arange(8.0).reshape(2, 4) * 3          # (1 + 2) x
    for r in range(2):
        o = res[r]
        assert torch.equal(o["psum"], x[0] + x[1])
        assert torch.allclose(o["pmean"], (x[0] + x[1]) / 2, rtol=1e-6)
        assert torch.equal(o["pmax"], x[1])
        assert torch.equal(o["gather1"], torch.cat(x, 1))
        assert torch.equal(o["scatter1"], s[:, 2 * r:2 * r + 2])
        assert torch.equal(o["bcast"], x[1])
        assert torch.equal(o["copy_grad"], torch.full((2, 3), 3.0))
        assert torch.equal(o["reduce_fwd"], x[0] + x[1])
        assert torch.equal(o["reduce_grad"], torch.full((2, 3), r + 1.0))
        assert torch.equal(o["gather_fwd"], torch.cat(x, 0))
        assert torch.equal(o["gather_grad"], torch.full((2, 3), 3.0))
    assert torch.equal(res[0]["reduce"], x[0] + x[1])
