"""Port parity for data/tensor-parallel serving: ``ServeEngine(mesh=...)``
of ``deepspeed_tpu_torch`` on 2 and 4 gloo ranks (dp2, tp2, dp2×tp2;
spawned processes, ``tests/test_torch_zero.py::spawn_ranks``) against
the port's one-device engine and the JAX ServeEngine on a dp2×tp2 mesh of
the virtual CPU devices (the counterparts of ``tests/test_inference.py::
test_serve_tp_dp_sharded_matches_single_device``, ``tests/test_paged_kv.py
::test_paged_tp_dp_sharded_matches_single_device``, ``tests/
test_quant_serve.py::test_quant_tp_dp_sharded_matches_single_device``,
``tests/test_spec_decode.py::test_spec_stream_parity_dp2_tp2`` and
``tests/test_adapters.py::test_lora_dp2_tp2_matches_single_device``),
plus the mesh validation errors, word for word the JAX package's.

Tolerances: greedy tokens must be equal, a flip allowed only where the
one-device port's top-2 logit gap at that step is under 1e-3 (each flip
is reported with its gap); a sampled stream (temperature 0.8, rejection-
sampling speculation) must equal the one-device port engine's under the
same seed, bit for bit; each rank's pool bytes are exactly 1/(dp·tp) of
the pool's.
"""
import numpy as np
import pytest
import torch

from test_torch_zero import spawn_ranks

from deepspeed_tpu_torch.inference import ServeEngine
from deepspeed_tpu_torch.inference.kv_cache import (
    KVCacheSpec, PagedKVCacheSpec, init_cache, init_paged_cache,
    paged_cache_shardings, shard_cache, validate_cache_mesh,
    validate_paged_cache_mesh)
from deepspeed_tpu_torch.models.gpt2 import (GPT2Config, GPT2Model,
                                             gpt2_prefill,
                                             params_from_numpy)
from deepspeed_tpu_torch.parallel.mesh import Mesh

SMALL = dict(vocab_size=256, n_positions=64, d_model=64, n_layer=2,
             n_head=4)
DRAFT = {"d_model": 32, "n_layer": 2, "n_head": 2}
LORA = {"rank": 4, "alpha": 8.0, "max_adapters": 8, "hbm_adapter_slots": 2,
        "targets": ["qkv_w", "out_w", "fc_w", "proj_w"]}
GAP = 1e-3
GEN = 6


def _prompts():
    rng = np.random.default_rng(3)
    tmpl = [int(t) for t in rng.integers(0, 256, 8)]
    out = [[int(t) for t in rng.integers(0, 256, n)] for n in (5, 9, 3)]
    # two template sharers (full shared pages, page_len 4) and a copy of
    # the first: prefix hits within a data rank
    return out + [tmpl + [1, 2], tmpl + [7], list(out[0])]


TENANTS = [0, 1, 2, 1, 0, 2]

#: name -> (serving block extras, draft?, tenants?)
JOBS = {
    "slot": ({}, False, False),
    "paged": ({"page_len": 4}, False, False),
    "quant": ({"page_len": 4, "quantization": {"weights": "int8",
                                               "kv": "int8"}},
              False, False),
    "spec_slot": ({"speculate_k": 2, "draft": DRAFT}, True, False),
    "spec_paged": ({"page_len": 4, "speculate_k": 4, "draft": DRAFT},
                   True, False),
    "spec_sampled": ({"page_len": 4, "speculate_k": 3, "draft": DRAFT,
                      "temperature": 0.8}, True, False),
    "lora": ({"page_len": 4, "lora": LORA}, False, True),
    # KV-page migration: each request's pages exported (gathered whole)
    # on finishing its prefill, then adopted back and decoded
    "migrate": ({"page_len": 4, "pages": 34}, False, False),
}


def _cfg(extra):
    return {"serving": {"slots": 4, "max_seq_len": 32, "prefill_len": 16,
                        **extra}}


def _trees():
    """The target's and the draft's weights from the JAX init (numpy)."""
    import jax
    from deepspeed_tpu.models.gpt2 import GPT2Config as JC, GPT2Model as JM
    t = JM(JC(**SMALL, remat=None, attn_impl="flash"))
    d = JM(JC(vocab_size=SMALL["vocab_size"],
              n_positions=SMALL["n_positions"], d_model=DRAFT["d_model"],
              n_layer=DRAFT["n_layer"], n_head=DRAFT["n_head"], remat=None,
              attn_impl="flash"))
    return (jax.tree.map(np.asarray, t.init(jax.random.PRNGKey(0))),
            jax.tree.map(np.asarray, d.init(jax.random.PRNGKey(1))))


def _serve(jobs, trees, mesh=None):
    """Each job's streams (and, under a mesh, this rank's pool bytes)."""
    tree, dtree = trees
    out = {}
    for name in jobs:
        extra, draft, lora = JOBS[name]
        eng = ServeEngine(GPT2Model(GPT2Config(**SMALL)), _cfg(extra),
                          mesh=mesh, params=params_from_numpy(tree),
                          draft_params=(params_from_numpy(dtree)
                                        if draft else None),
                          seed=0, device="cpu")
        payloads = []
        if name == "migrate":
            reqs = []
            for p in _prompts():
                src = eng.submit(p, max_new_tokens=1, detach_kv=True)
                eng.run_until_idle()
                payloads.append(eng.export_pages(src))
                eng.release_detached(src)
                reqs.append(eng.adopt_request(p, src.tokens[0], GEN, None,
                                              payloads[-1]))
                eng.run_until_idle()
        else:
            reqs = [eng.submit(p, max_new_tokens=GEN,
                               adapter_id=TENANTS[i] if lora else 0)
                    for i, p in enumerate(_prompts())]
        eng.run_until_idle()
        pool = sum(eng.cache[k].numel() * eng.cache[k].element_size()
                   for k in ("k", "v", "k_scale", "v_scale")
                   if k in eng.cache)
        out[name] = {"tokens": [r.tokens for r in reqs],
                     "errors": [repr(r.error) for r in reqs
                                if r.error is not None],
                     "pool_bytes": pool,
                     "spec_bytes": eng.cache_spec.bytes,
                     "cow": eng.prefix.cow if eng.prefix else 0,
                     "payloads": payloads}
        eng.close()
        out[name]["refs_after_close"] = (dict(eng.pool.refs) if eng.pool
                                         else {})
    return out


def _live_rows(payloads, n):
    """A request's migrated K and V rows ``[2, L, H, n, Dh]`` (fp32)
    from its page payloads (each k then v ``[L, H, page_len, Dh]``)."""
    L, H, Dh = SMALL["n_layer"], SMALL["n_head"], 16
    pages = np.stack([np.frombuffer(x, np.float32).reshape(2, L, H, 4, Dh)
                      for x in payloads], axis=3)      # [2, L, H, P, 4, Dh]
    return pages.reshape(2, L, H, -1, Dh)[:, :, :, :n]


def _mesh_job(rank, world, tp, jobs, trees):
    from deepspeed_tpu_torch.parallel import build_mesh
    return _serve(jobs, trees, build_mesh(tp=tp))


@pytest.fixture(scope="module")
def trees():
    return _trees()


@pytest.fixture(scope="module")
def single(trees):
    return _serve(list(JOBS), trees)


def _jax_streams(name, trees, mesh):
    from deepspeed_tpu.inference import ServeEngine as JaxServeEngine
    from deepspeed_tpu.models.gpt2 import GPT2Config as JC, GPT2Model as JM
    extra, draft, lora = JOBS[name]
    tree, dtree = trees
    eng = JaxServeEngine(JM(JC(**SMALL, remat=None, attn_impl="flash")),
                         _cfg(extra), mesh=mesh, params=tree,
                         draft_params=dtree if draft else None)
    reqs = [eng.submit(p, max_new_tokens=GEN,
                       adapter_id=TENANTS[i] if lora else 0)
            for i, p in enumerate(_prompts())]
    eng.run_until_idle()
    out = [r.result() for r in reqs]
    eng.close()
    return out


def _assert_streams(got, ref, trees, what):
    """Greedy streams equal; a divergence is allowed only on a near tie
    of the one-device port model (reported with its gap)."""
    params = params_from_numpy(trees[0])
    cfg = GPT2Config(**SMALL)
    for prompt, g, r in zip(_prompts(), got, ref):
        if g == r:
            continue
        i = next(j for j, (a, b) in enumerate(zip(g, r)) if a != b)
        logits, _, _ = gpt2_prefill(cfg, params,
                                    torch.tensor([prompt + r[:i]]))
        top = torch.topk(logits[0, -1].float(), 2).values
        gap = float(top[0] - top[1])
        print(f"{what}: token {i} flipped {r[i]} -> {g[i]} at a top-2 "
              f"gap of {gap:.2e}")
        assert gap < GAP, (what, prompt, g, r, gap)


@pytest.mark.parametrize("dp,tp", [(2, 1), (1, 2), (2, 2)],
                         ids=["dp2", "tp2", "dp2tp2"])
def test_mesh_streams_match_single_device(tmp_path, trees, single, dp, tp):
    """Every serving path on gloo ranks: each rank's streams equal the
    one-device port engine's (greedy: equal up to reported near-tie
    flips; sampled: bitwise under the seed), every rank the same, and
    each rank holds 1/(dp·tp) of the pool's bytes."""
    ranks = spawn_ranks(_mesh_job, dp * tp, tmp_path, tp, list(JOBS),
                        trees, timeout=400.0)
    for name in JOBS:
        ref = single[name]
        for r, res in enumerate(ranks):
            got = res[name]
            assert not got["errors"], (name, r, got["errors"])
            assert got["tokens"] == ranks[0][name]["tokens"], (name, r)
            if name == "spec_sampled":
                assert got["tokens"] == ref["tokens"], (name, r)
            elif name == "lora":
                assert got["tokens"] == ref["tokens"], (name, r)
            else:
                _assert_streams(got["tokens"], ref["tokens"], trees,
                                f"{name} dp{dp}tp{tp} rank {r}")
            assert got["pool_bytes"] * dp * tp == got["spec_bytes"], (
                name, got["pool_bytes"], got["spec_bytes"])
            assert got["refs_after_close"] == {}
            # the migrated pages' live rows are the single device's within
            # fp32 1e-5 (a data split changes which prompts share prefix
            # pages, and so which prefill arm computed a row; dead rows of
            # a last page are whatever the page held before)
            for p, a, b in zip(_prompts(), got["payloads"],
                               ref["payloads"]):
                np.testing.assert_allclose(_live_rows(a, len(p)),
                                           _live_rows(b, len(p)),
                                           rtol=1e-5, atol=1e-5)
        if name in ("paged", "quant") and dp == 1:
            # one page range: the allocator is the single device's
            assert ranks[0][name]["cow"] == ref["cow"]


@pytest.mark.parametrize("name", ["slot", "paged", "quant", "spec_slot",
                                  "spec_paged", "lora"])
def test_single_device_matches_jax_mesh(trees, single, name):
    """The one-device port streams equal the JAX engine's on its dp2×tp2
    virtual mesh (which the JAX tests hold to its one device), so the
    port's meshes above match the JAX meshes."""
    import jax
    from deepspeed_tpu.parallel import build_mesh
    jax_out = _jax_streams(name, trees, build_mesh(
        dp=2, tp=2, devices=jax.devices()[:4]))
    _assert_streams(single[name]["tokens"], jax_out, trees,
                    f"{name} port one device vs JAX dp2tp2")


def _fake_mesh(pp=1, dp=1, tp=1):
    """A mesh view with no process group behind it (validation only)."""
    return Mesh((pp, dp, 1, tp), rank=0, groups={})


def test_cache_mesh_validation():
    spec = KVCacheSpec(layers=2, slots=3, heads=4, max_len=8, head_dim=8)
    with pytest.raises(ValueError, match="slots"):
        validate_cache_mesh(_fake_mesh(dp=2), spec)
    spec2 = KVCacheSpec(layers=2, slots=4, heads=3, max_len=8, head_dim=8)
    with pytest.raises(ValueError, match="model axis"):
        validate_cache_mesh(_fake_mesh(tp=2), spec2)
    with pytest.raises(ValueError, match="pipe"):
        validate_cache_mesh(_fake_mesh(pp=2), KVCacheSpec(
            layers=2, slots=4, heads=4, max_len=8, head_dim=8))


def test_paged_cache_mesh_validation_and_shard_shapes():
    spec = PagedKVCacheSpec(layers=2, slots=4, heads=4, pages=7,
                            page_len=4, head_dim=8, max_pages=2)
    with pytest.raises(ValueError, match="pages"):
        validate_paged_cache_mesh(_fake_mesh(dp=2), spec)
    spec2 = PagedKVCacheSpec(layers=2, slots=4, heads=3, pages=8,
                             page_len=4, head_dim=8, max_pages=2)
    with pytest.raises(ValueError, match="model axis"):
        validate_paged_cache_mesh(_fake_mesh(tp=2), spec2)
    ok = PagedKVCacheSpec(layers=2, slots=4, heads=4, pages=8, page_len=4,
                          head_dim=8, max_pages=2, dtype=torch.int8,
                          quant=True)
    mesh = _fake_mesh(dp=2, tp=2)
    sh = paged_cache_shardings(mesh, quant=True)
    whole = init_paged_cache(ok)
    placed = shard_cache(whole, mesh, sh)
    direct = init_paged_cache(ok, shardings=sh)
    for k in whole:
        assert placed[k].shape == direct[k].shape
    assert placed["k"].shape == (2, 4, 2, 4, 8)
    assert placed["k_scale"].shape == (2, 4, 2, 4)
    assert placed["lengths"].shape == (4,)
    # the JAX package's byte counts, and the slot cache's split
    assert ok.page_bytes == 2 * 2 * 4 * 4 * (8 + 4)
    assert shard_cache(init_cache(KVCacheSpec(
        layers=2, slots=8, heads=4, max_len=8, head_dim=4)),
        mesh)["k"].shape == (2, 4, 2, 8, 4)


def _uneven_paged_job(rank, world, trees):
    import torch.distributed as dist
    from deepspeed_tpu_torch.parallel import build_mesh
    mesh = build_mesh()
    # no rank tears its groups down while another still builds them
    dist.barrier()
    try:
        ServeEngine(GPT2Model(GPT2Config(**SMALL)), {"serving": {
            "slots": 3, "max_seq_len": 32, "prefill_len": 16,
            "page_len": 4}}, params=params_from_numpy(trees[0]),
            mesh=mesh, seed=0, device="cpu")
    except ValueError as e:
        return str(e)
    return None


def test_paged_slots_must_divide_dp_on_gloo_ranks(tmp_path, trees):
    """On the paged layout each data rank serves its own slot range from
    its own pages: 3 slots on 2 data ranks is refused at build on every
    rank (a remainder slot would belong to no rank)."""
    errs = spawn_ranks(_uneven_paged_job, 2, tmp_path, trees)
    for e in errs:
        assert e is not None and "serving.slots=3" in e \
            and "data axis (2)" in e, errs


def test_draft_heads_must_divide_tp(trees):
    with pytest.raises(ValueError, match="divisible"):
        ServeEngine(GPT2Model(GPT2Config(**SMALL)), {"serving": {
            "slots": 2, "max_seq_len": 32, "prefill_len": 16,
            "speculate_k": 2,
            "draft": {"d_model": 30, "n_layer": 1, "n_head": 3}}},
            params=params_from_numpy(trees[0]), mesh=_fake_mesh(tp=2),
            device="cpu")


def test_quantized_partition_specs_follow_the_column_split():
    from deepspeed_tpu_torch.inference.quantize import \
        quantized_partition_specs
    specs = quantized_partition_specs(
        GPT2Model(GPT2Config(**SMALL)).param_partition_specs(None))
    b = specs["blocks"]
    assert b["qkv_w_scale"] == (None, None, None, "model")
    assert b["fc_w_scale"] == (None, None, "model")
    assert b["out_w_scale"] == (None, None, None)
    assert b["proj_w_scale"] == (None, None, None)
