"""The port's serving layer (repro_torch.serving) against repro.serving on
the CPU, case for case with tests/test_serving.py: plan-cache keying and
LRU, the transform cache (one transform per corpus), the batcher
(coalesced answers bitwise per-request corr(), dense and top-k, ragged
tile-straddling slabs) and CorrServer with concurrent submission and
per-request stats.

Tolerances: inside the port every served answer is bitwise the port's own
corr(); against the reference 3e-6 on float32 values (both sum the same
float32 products in other orders), exact on top-k indices, spec_dict()
and plan-cache counts and keys.  Every future waits at most 30 s and
every server closes through a context manager, so a hung dispatcher fails
one test.
"""

import gc
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as ref_api
from repro.core.api import corr as ref_corr
from repro.core.plan import ExecutionPlan as RefPlan
from repro.core.sinks import TopKSink as RefTopKSink
from repro.serving import CorpusHandle as RefCorpusHandle
from repro.serving import PlanCache as RefPlanCache
from repro.serving import ProblemSpec as RefProblemSpec
from repro.serving import Query as RefQuery
from repro.serving import QueryBatcher as RefQueryBatcher
from repro.serving import bucket_rows as ref_bucket_rows
from repro_torch.core import api, measures
from repro_torch.core.api import corr
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.sinks import RowBlockSink, TopKSink
from repro_torch.launch.mesh import make_mesh
from repro_torch.serving import (CorpusHandle, CorrServer, PlanCache,
                                 ProblemSpec, Query, QueryBatcher,
                                 bucket_rows)

T, LBLK = 8, 8
KW = dict(t=T, l_blk=LBLK, device="cpu")
ATOL = 3e-6
WAIT = 30


def _x(n, l, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, l)).astype(np.float32)


@pytest.fixture
def corpus():
    return CorpusHandle(_x(40, 12, seed=100), **KW)


@pytest.fixture(autouse=True)
def _fresh_prepared_cache():
    api.clear_prepared_cache()
    ref_api.clear_prepared_cache()
    yield
    api.clear_prepared_cache()
    ref_api.clear_prepared_cache()


def _ref_dense(probes, corpus, measure="pearson"):
    """The port's own standalone answer (served answers are its bits)."""
    return corr(probes, corpus.x, t=T, l_blk=LBLK, device="cpu",
                measure=measure).numpy()


def _ref_topk(probes, corpus, k, measure="pearson"):
    return corr(probes, corpus.x, t=T, l_blk=LBLK, device="cpu",
                measure=measure, sink=TopKSink(k))


def _jax_dense(probes, corpus_np, measure="pearson"):
    """The reference package's answer on the same numpy inputs."""
    return np.asarray(ref_corr(jnp.asarray(probes), jnp.asarray(corpus_np),
                               t=T, l_blk=LBLK, measure=measure))


# -- PlanCache keying ------------------------------------------------------------


def _spec(rows=5, cols=40, l=12, **kw):
    kw.setdefault("t", T)
    kw.setdefault("l_blk", LBLK)
    return ProblemSpec.for_query(rows, cols, l, **kw)


def _ref_spec(rows=5, cols=40, l=12, **kw):
    kw.setdefault("t", T)
    kw.setdefault("l_blk", LBLK)
    return RefProblemSpec.for_query(rows, cols, l, **kw)


def _fields(spec):
    """A spec's key fields by name (the port has no `interpret`)."""
    return {k: getattr(spec, k) for k in (
        "measure", "rows", "cols", "l", "t", "l_blk", "compute_dtype",
        "clip", "fuse_epilogue", "max_tiles_per_pass", "mesh")}


def test_plan_cache_hit_on_equal_spec():
    pc, rpc = PlanCache(), RefPlanCache()
    p1, hit1 = pc.get(_spec())
    p2, hit2 = pc.get(_spec())
    assert (hit1, hit2) == (False, True)
    assert p1 is p2
    assert pc.stats() == {"hits": 1, "misses": 1, "size": 1, "capacity": 32}
    r1, _ = rpc.get(_ref_spec())
    rpc.get(_ref_spec())
    assert rpc.stats() == pc.stats()
    assert p1.spec_dict() == r1.spec_dict()
    assert _fields(_spec()) == _fields(_ref_spec())


def test_plan_cache_bucketing_shares_plans_within_a_tile():
    pc = PlanCache()
    p1, _ = pc.get(_spec(rows=1))
    p2, hit = pc.get(_spec(rows=T))
    assert hit and p1 is p2
    _, hit3 = pc.get(_spec(rows=T + 1))
    assert not hit3
    for m in (1, T, T + 1, 3 * T + 2):
        assert bucket_rows(m, T) == ref_bucket_rows(m, T)
    assert bucket_rows(1, T) == T and bucket_rows(T + 1, T) == 2 * T
    with pytest.raises(ValueError, match="positive"):
        bucket_rows(0, T)


@pytest.mark.parametrize("delta", [
    dict(measure="cosine"),               # measure change
    dict(compute_dtype="bfloat16"),       # dtype change
    dict(rows=T + 1),                     # shape-bucket change
    dict(cols=41),                        # corpus-size change
    dict(l=13),                           # sample-count change
    dict(max_tiles_per_pass=2),           # pass-partition change
])
def test_plan_cache_misses_on_spec_change(delta):
    pc, rpc = PlanCache(), RefPlanCache()
    pc.get(_spec())
    plan, hit = pc.get(_spec(**delta))
    assert not hit
    assert pc.stats()["misses"] == 2
    rd = {**delta}
    if "compute_dtype" in rd:
        rd["compute_dtype"] = jnp.bfloat16
    rpc.get(_ref_spec())
    ref_plan, _ = rpc.get(_ref_spec(**rd))
    assert rpc.stats() == pc.stats()
    assert plan.spec_dict() == ref_plan.spec_dict()
    assert _fields(_spec(**delta)) == _fields(_ref_spec(**rd))


def test_plan_cache_misses_on_mesh_change():
    """A mesh is another key, as in the reference: its shape and the
    device of each rank; its size is the plan's p.  Anything but a
    launch.mesh.Mesh is refused before any plan is built."""
    import jax
    rpc = RefPlanCache()
    rpc.get(_ref_spec())
    _, hit = rpc.get(_ref_spec(mesh=jax.make_mesh((1,), ("d",))))
    assert not hit
    pc = PlanCache()
    pc.get(_spec())
    m4 = make_mesh((4,), ("d",), devices=["cpu"] * 4)
    plan, hit = pc.get(_spec(mesh=m4))
    assert not hit and plan.p == _spec(mesh=m4).p == 4
    assert _spec().p == 1
    assert plan.spec_dict() == RefPlan.create(
        T, 12, n_cols=40, t=T, l_blk=LBLK, p=4, interpret=True).spec_dict()
    _, hit = pc.get(_spec(mesh=make_mesh((4,), ("d",), devices=["cpu"] * 4)))
    assert hit
    _, hit = pc.get(_spec(mesh=make_mesh((2, 2), ("a", "b"),
                                         devices=["cpu"] * 4)))
    assert not hit
    assert pc.stats()["misses"] == 3
    with pytest.raises(TypeError, match="Mesh"):
        pc.get(_spec(mesh=object()))
    assert pc.stats()["misses"] == 3
    with pytest.raises(TypeError, match="Mesh"):
        CorrServer(_x(16, 12), mesh=object(), **KW)


def test_plan_cache_bounded_lru_eviction():
    for cache, spec in ((PlanCache(capacity=2), _spec),
                        (RefPlanCache(capacity=2), _ref_spec)):
        s1, s2, s3 = spec(rows=1), spec(rows=T + 1), spec(rows=2 * T + 1)
        cache.get(s1)
        cache.get(s2)
        cache.get(s1)          # refresh s1: s2 becomes the LRU
        cache.get(s3)          # evicts s2
        assert len(cache) == 2 and s2 not in cache and s1 in cache \
            and s3 in cache
        _, hit = cache.get(s2)
        assert not hit
    with pytest.raises(ValueError, match="positive"):
        PlanCache(capacity=0)


def test_plan_cache_serves_unregistered_custom_measures():
    custom = measures.Measure("my_dot", measures.identity_transform, None,
                              None)
    xc = _x(24, 12, seed=9)
    handle = CorpusHandle(xc, **KW)
    bat = QueryBatcher(handle, measure=custom, **KW)
    p = _x(3, 12, seed=10)
    results, _ = bat.execute([Query(p)])
    np.testing.assert_array_equal(results[0], corr(
        p, handle.x, measure=custom, **KW).numpy())
    np.testing.assert_allclose(results[0], _jax_dense(p, xc, "dot"),
                               rtol=0, atol=ATOL)
    # a shadowing instance (a registered name, other semantics) must not
    # collide with the registry singleton
    shadow = measures.Measure("pearson", measures.identity_transform, None,
                              None)
    pc = bat.plan_cache
    n0 = pc.stats()["misses"]
    bat2 = QueryBatcher(handle, measure=shadow, plan_cache=pc, **KW)
    res_shadow, _ = bat2.execute([Query(p)])
    assert pc.stats()["misses"] == n0 + 1
    ref_shadow = corr(p, handle.x, measure=shadow, **KW).numpy()
    np.testing.assert_array_equal(res_shadow[0], ref_shadow)
    assert not np.array_equal(res_shadow[0], _ref_dense(p, handle))
    mixed, infos = bat2.execute([Query(p, measure=shadow),
                                 Query(p, measure="pearson")])
    np.testing.assert_array_equal(mixed[0], ref_shadow)
    np.testing.assert_array_equal(mixed[1], _ref_dense(p, handle))
    assert infos[0] is not infos[1]


def test_spec_key_matches_spec_dict_identity():
    plan = ExecutionPlan.create(16, 12, n_cols=40, t=T, l_blk=LBLK)
    same = ExecutionPlan.create(16, 12, n_cols=40, t=T, l_blk=LBLK)
    other = ExecutionPlan.create(16, 12, n_cols=40, t=T, l_blk=LBLK,
                                 measure="cosine")
    assert plan.spec_key() == same.spec_key()
    assert hash(plan.spec_key()) == hash(same.spec_key())
    assert plan.spec_key() != other.spec_key()
    assert dict(plan.spec_key()) == plan.spec_dict()
    ref = RefPlan.create(16, 12, n_cols=40, t=T, l_blk=LBLK)
    assert plan.spec_key() == ref.spec_key()


# -- transform cache: one transform per corpus -----------------------------------------


def _count_prepares(monkeypatch):
    calls = []
    real = ExecutionPlan._prepare_one

    def spy(self, x):
        calls.append(tuple(x.shape))
        return real(self, x)

    monkeypatch.setattr(ExecutionPlan, "_prepare_one", spy)
    return calls


def test_corr_symmetric_transforms_once_per_corpus(monkeypatch):
    calls = _count_prepares(monkeypatch)
    x = torch.from_numpy(_x(33, 12, seed=1))
    r1 = corr(x, **KW)
    r2 = corr(x, **KW)
    assert len(calls) == 1
    assert torch.equal(r1, r2)
    corr(x, measure="cosine", **KW)
    assert len(calls) == 2
    # host numpy converts to a fresh tensor per call: no identity to key on
    xh = x.numpy().copy()
    corr(xh, **KW)
    corr(xh, **KW)
    assert len(calls) == 4
    np.testing.assert_allclose(r1.numpy(), np.asarray(ref_corr(
        jnp.asarray(xh), t=T, l_blk=LBLK)), rtol=0, atol=ATOL)


def test_corr_rectangular_reuses_cached_corpus_transform(monkeypatch):
    calls = _count_prepares(monkeypatch)
    x, y = (torch.from_numpy(_x(5, 12, seed=2)),
            torch.from_numpy(_x(40, 12, seed=3)))
    corr(x, y, **KW)
    assert len(calls) == 2
    x2 = torch.from_numpy(_x(7, 12, seed=4))
    corr(x2, y, **KW)
    assert len(calls) == 3          # y served from the cache across calls


def test_corpus_handle_one_transform_per_measure(monkeypatch):
    x = _x(40, 12, seed=5)
    handle = CorpusHandle(x, **KW)
    calls = []
    real = CorpusHandle._prepare
    monkeypatch.setattr(
        CorpusHandle, "_prepare",
        lambda self, meas, cd: (calls.append(meas.name),
                                real(self, meas, cd))[1])
    for _ in range(3):
        handle.operand("pearson")
    handle.operand("cosine")
    handle.operand("cosine")
    assert calls == ["pearson", "cosine"]
    assert handle.stats()["misses"] == 2 and handle.stats()["hits"] == 3
    # the reference counts the same and prepares the same operand
    ref = RefCorpusHandle(jnp.asarray(x), t=T, l_blk=LBLK)
    for _ in range(3):
        want = ref.operand("pearson")
    ref.operand("cosine")
    ref.operand("cosine")
    assert {k: ref.stats()[k] for k in ("hits", "misses", "size")} == \
        {k: handle.stats()[k] for k in ("hits", "misses", "size")}
    norms = handle.row_norms("pearson").numpy()
    np.testing.assert_allclose(norms, 1.0, atol=1e-5)
    np.testing.assert_allclose(handle.operand("pearson").numpy(),
                               np.asarray(want), rtol=0, atol=ATOL)


def test_transform_cache_lru_and_identity_guard():
    """The handle's private cache, as the reference's: bounded, keyed by
    the corpus tensor; a handle copies its corpus, so writing the caller's
    array afterwards changes nothing served."""
    x = _x(16, 12, seed=6)
    handle = CorpusHandle(x, cache_capacity=2, **KW)
    for name in ("pearson", "cosine", "covariance"):
        handle.operand(name)
    st = handle.stats()
    assert st["size"] == 2 and st["misses"] == 3
    handle.operand("pearson")        # evicted: a miss again
    assert handle.stats()["misses"] == 4
    before = handle.operand("cosine").clone()
    x[:] = 0.0
    assert torch.equal(handle.operand("cosine"), before)
    with pytest.raises(ValueError, match="capacity"):
        CorpusHandle(_x(8, 8), cache_capacity=0, **KW)


def test_transform_cache_entries_die_with_their_operand():
    """The cache never extends an operand's lifetime: dropping the tensor
    evicts its entry; a corpus append builds a new tensor, and the old
    tensor's entry dies with it."""
    x = torch.from_numpy(_x(16, 10, seed=8))
    corr(x, **KW)
    assert api.prepared_cache_stats()["size"] == 1
    del x
    gc.collect()
    assert api.prepared_cache_stats()["size"] == 0
    handle = CorpusHandle(_x(16, 10, seed=8), **KW)
    handle.operand("spearman")
    assert len(handle._cache) == 1
    with pytest.warns(UserWarning, match="no incremental"):
        handle.append(_x(2, 10, seed=9))
    gc.collect()
    assert len(handle._cache) == 0
    handle.operand("spearman")
    assert len(handle._cache) == 1 and handle.stats()["misses"] == 2


def test_corr_numpy_inputs_do_not_pollute_cache():
    xh = _x(12, 10, seed=6)
    corr(xh, **KW)
    corr(xh, **KW)
    assert api.prepared_cache_stats()["size"] == 0
    yh = _x(9, 10, seed=7)
    corr(xh, yh, **KW)
    assert api.prepared_cache_stats() == {
        "hits": 0, "misses": 0, "size": 0, "capacity": 8}


# -- QueryBatcher: coalesced == per request, bit for bit ------------------------------


def test_batched_dense_bit_identical_to_per_request(corpus):
    """Ragged probe counts straddling tile edges (5 + 7 + 9 rows at t = 8),
    bitwise the port's corr and within 3e-6 of the reference batcher."""
    bat = QueryBatcher(corpus, **KW)
    probes = [_x(m, 12, seed=10 + m) for m in (5, 7, 9)]
    results, infos = bat.execute([Query(p) for p in probes])
    for p, got in zip(probes, results):
        np.testing.assert_array_equal(got, _ref_dense(p, corpus))
    assert infos[0].requests == 3 and infos[0].rows == 21
    assert infos[0].rows_bucket == bucket_rows(21, T)
    assert infos[0] is infos[1] is infos[2]
    ref = RefQueryBatcher(RefCorpusHandle(jnp.asarray(corpus.x.numpy()),
                                          t=T, l_blk=LBLK), t=T, l_blk=LBLK)
    want, rinfos = ref.execute([RefQuery(jnp.asarray(p)) for p in probes])
    for got, w in zip(results, want):
        np.testing.assert_allclose(got, np.asarray(w), rtol=0, atol=ATOL)
    assert (rinfos[0].requests, rinfos[0].rows, rinfos[0].rows_bucket) == \
        (infos[0].requests, infos[0].rows, infos[0].rows_bucket)


def test_batched_single_probe_rows(corpus):
    bat = QueryBatcher(corpus, **KW)
    probes = [_x(1, 12, seed=20 + i) for i in range(5)]
    results, infos = bat.execute([Query(p) for p in probes])
    for p, got in zip(probes, results):
        np.testing.assert_array_equal(got, _ref_dense(p, corpus))
    assert infos[0].rows == 5 and infos[0].rows_bucket == T
    np.testing.assert_allclose(results[2], _jax_dense(
        probes[2], corpus.x.numpy()), rtol=0, atol=ATOL)


def test_batched_topk_bit_identical_including_mixed_k(corpus):
    bat = QueryBatcher(corpus, **KW)
    pa, pb = _x(5, 12, seed=30), _x(11, 12, seed=31)
    results, _ = bat.execute([Query(pa, k=3), Query(pb, k=7)])
    cx = jnp.asarray(corpus.x.numpy())
    for p, k, got in [(pa, 3, results[0]), (pb, 7, results[1])]:
        ref = _ref_topk(p, corpus, k)
        np.testing.assert_array_equal(got["indices"], ref["indices"])
        np.testing.assert_array_equal(got["values"], ref["values"])
        want = ref_corr(jnp.asarray(p), cx, t=T, l_blk=LBLK,
                        sink=RefTopKSink(k))
        np.testing.assert_array_equal(got["indices"], want["indices"])
        np.testing.assert_allclose(got["values"], want["values"], rtol=0,
                                   atol=ATOL)


def test_batched_mixed_kinds_and_measures(corpus):
    bat = QueryBatcher(corpus, **KW)
    pa, pb, pc_, pd = (_x(m, 12, seed=40 + m) for m in (3, 6, 4, 2))
    results, infos = bat.execute([
        Query(pa), Query(pb, k=4), Query(pc_, measure="cosine"), Query(pd)])
    np.testing.assert_array_equal(results[0], _ref_dense(pa, corpus))
    ref_b = _ref_topk(pb, corpus, 4)
    np.testing.assert_array_equal(results[1]["indices"], ref_b["indices"])
    np.testing.assert_array_equal(
        results[2], _ref_dense(pc_, corpus, measure="cosine"))
    np.testing.assert_array_equal(results[3], _ref_dense(pd, corpus))
    assert infos[0] is infos[3] and infos[0].requests == 2
    assert infos[1].requests == 1 and infos[2].requests == 1
    np.testing.assert_allclose(results[2], _jax_dense(
        pc_, corpus.x.numpy(), "cosine"), rtol=0, atol=ATOL)


def test_batched_topk_bit_identical_under_ties_and_multipass():
    """Exact |r| ties (duplicated corpus rows) keep the contract: the top-k
    order is canonical, so the sliced batch run equals per-request runs
    under other pass partitions."""
    base = _x(10, 12, seed=33)
    dup = np.concatenate([base, base, base[:4]])
    handle = CorpusHandle(dup, **KW)
    bat = QueryBatcher(handle, max_tiles_per_pass=1, **KW)
    pa, pb = base[:3], base[4:9]
    results, _ = bat.execute([Query(pa, k=5), Query(pb, k=8)])
    for p, k, got in [(pa, 5, results[0]), (pb, 8, results[1])]:
        for mtp in (None, 2):
            ref = corr(p, handle.x, max_tiles_per_pass=mtp,
                       sink=TopKSink(k), **KW)
            np.testing.assert_array_equal(got["indices"], ref["indices"])
            np.testing.assert_array_equal(got["values"], ref["values"])
        want = ref_corr(jnp.asarray(p), jnp.asarray(dup), t=T, l_blk=LBLK,
                        sink=RefTopKSink(k))
        np.testing.assert_allclose(got["values"], want["values"], rtol=0,
                                   atol=ATOL)


def test_batcher_plan_cache_hits_across_batches(corpus):
    pc = PlanCache()
    bat = QueryBatcher(corpus, plan_cache=pc, **KW)
    bat.execute([Query(_x(5, 12, seed=50))])
    assert pc.stats() == {"hits": 0, "misses": 1, "size": 1, "capacity": 32}
    _, infos = bat.execute([Query(_x(3, 12, seed=51))])
    assert infos[0].plan_cache_hit and pc.stats()["hits"] == 1


def test_batcher_multi_pass_launches_match(corpus):
    bat = QueryBatcher(corpus, max_tiles_per_pass=2, **KW)
    probes = [_x(m, 12, seed=60 + m) for m in (7, 9)]
    results, infos = bat.execute([Query(p) for p in probes])
    assert infos[0].passes > 1
    for p, got in zip(probes, results):
        np.testing.assert_array_equal(got, _ref_dense(p, corpus))


def test_batcher_rejections(corpus):
    bat = QueryBatcher(corpus, **KW)
    with pytest.raises(ValueError, match="samples"):
        bat.execute([Query(_x(3, 11, seed=70))])
    with pytest.raises(ValueError, match="positive"):
        Query(_x(3, 12), k=0)
    with pytest.raises(ValueError, match="probes"):
        Query(np.zeros((0, 12), np.float32))
    with pytest.raises(ValueError, match="alignment"):
        QueryBatcher(corpus, t=16, l_blk=LBLK, device="cpu")


def test_row_block_sink_contract():
    cpu = torch.device("cpu")
    plan = ExecutionPlan.create(16, 12, n_cols=20, t=T, l_blk=LBLK)
    with pytest.raises(ValueError, match="exceeds"):
        RowBlockSink([(0, 17)]).open(plan, cpu)
    with pytest.raises(ValueError, match="bad row range"):
        RowBlockSink([(4, 2)])
    sym = ExecutionPlan.create(16, 12, t=T, l_blk=LBLK)
    with pytest.raises(ValueError, match="grid"):
        RowBlockSink([(0, 4)]).open(sym, cpu)


def test_prepare_rows_seam():
    plan = ExecutionPlan.create(16, 12, n_cols=40, t=T, l_blk=LBLK)
    x = _x(5, 12, seed=80)
    u = plan.prepare_rows(torch.from_numpy(x))
    assert u.shape[0] == plan.n_pad == 16
    assert bool((u[5:] == 0).all())
    want = RefPlan.create(16, 12, n_cols=40, t=T,
                          l_blk=LBLK).prepare_rows(jnp.asarray(x))
    np.testing.assert_allclose(u.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    # slabs of a batch: each transformed at its own shape, then stacked
    parts = [torch.from_numpy(_x(m, 12, seed=83 + m)) for m in (3, 6)]
    both = plan.prepare_rows(parts)
    assert torch.equal(both[:3], plan.prepare_rows(parts[0])[:3])
    assert torch.equal(both[3:9], plan.prepare_rows(parts[1])[:6])
    assert bool((both[9:] == 0).all())
    q = ExecutionPlan.create(16, 12, n_cols=40, t=T, l_blk=LBLK,
                             compute_dtype="int8")
    qu = q.prepare_rows(parts)
    assert qu.data.shape == (16, 16) and bool((qu.scale[9:] == 0).all())
    with pytest.raises(ValueError, match="rows"):
        plan.prepare_rows(torch.from_numpy(_x(17, 12, seed=81)))
    with pytest.raises(ValueError, match="sample count"):
        plan.prepare_rows(torch.from_numpy(_x(5, 13, seed=82)))


# -- CorrServer end to end --------------------------------------------------------------


def test_server_concurrent_submissions_bit_identical(corpus):
    probes = [_x(m, 12, seed=90 + i) for i, m in
              enumerate([1, 5, 7, 3, 9, 2, 4, 6])]
    refs = [_ref_dense(p, corpus) for p in probes]
    with CorrServer(corpus, max_wait_s=0.2, **KW) as srv:
        futs = [None] * len(probes)

        def submit(i):
            futs[i] = srv.submit(probes[i])

        threads = [threading.Thread(target=submit, args=(i,))
                   for i in range(len(probes))]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        results = [f.result(timeout=WAIT) for f in futs]
        stats = srv.stats()
    for ref, res in zip(refs, results):
        np.testing.assert_array_equal(res.value, ref)
        assert res.stats["queue_s"] >= 0
        assert 0 < res.stats["batch_occupancy"] <= 1.0
        assert res.stats["batch_requests"] >= 1
    assert stats["requests"] == len(probes)
    assert stats["batches"] < len(probes)
    assert stats["corpus"]["misses"] == 1      # one corpus transform
    np.testing.assert_allclose(results[4].value, _jax_dense(
        probes[4], corpus.x.numpy()), rtol=0, atol=ATOL)


def test_server_sync_query_and_topk(corpus):
    with CorrServer(corpus, max_wait_s=0.0, **KW) as srv:
        p = _x(6, 12, seed=200)
        res = srv.query(p, k=5, timeout=WAIT)
        ref = _ref_topk(p, corpus, 5)
        np.testing.assert_array_equal(res.value["indices"], ref["indices"])
        np.testing.assert_array_equal(res.value["values"], ref["values"])
        dense = srv.query(p, timeout=WAIT)
        np.testing.assert_array_equal(dense.value, _ref_dense(p, corpus))
        assert dense.stats["plan_cache_hit"]
    want = ref_corr(jnp.asarray(p), jnp.asarray(corpus.x.numpy()), t=T,
                    l_blk=LBLK, sink=RefTopKSink(5))
    np.testing.assert_array_equal(res.value["indices"], want["indices"])


def test_server_batch_error_fails_futures_not_server(corpus):
    with CorrServer(corpus, max_wait_s=0.0, **KW) as srv:
        bad = srv.submit(_x(3, 11, seed=201))  # wrong sample count
        with pytest.raises(ValueError, match="samples"):
            bad.result(timeout=WAIT)
        good = srv.query(_x(3, 12, seed=202), timeout=WAIT)
        np.testing.assert_array_equal(
            good.value, _ref_dense(_x(3, 12, seed=202), corpus))


def test_server_close_drains_and_rejects_new(corpus):
    srv = CorrServer(corpus, max_wait_s=5.0, **KW)
    try:
        p = _x(4, 12, seed=203)
        fut = srv.submit(p)
        srv.close()  # must not strand the queued request
        np.testing.assert_array_equal(fut.result(timeout=WAIT).value,
                                      _ref_dense(p, corpus))
        with pytest.raises(RuntimeError, match="closed"):
            srv.submit(p)
    finally:
        srv.close()  # idempotent
    assert not srv._thread.is_alive()


def test_server_survives_future_cancellation(corpus):
    with CorrServer(corpus, max_wait_s=0.2, **KW) as srv:
        fut = srv.submit(_x(3, 12, seed=220))
        cancelled = fut.cancel()
        p = _x(4, 12, seed=221)
        res = srv.query(p, timeout=WAIT)
        np.testing.assert_array_equal(res.value, _ref_dense(p, corpus))
        if cancelled:
            assert fut.cancelled()
        else:
            fut.result(timeout=WAIT)


def test_server_max_batch_rows_splits_batches(corpus):
    with CorrServer(corpus, max_wait_s=0.05, max_batch_rows=8, **KW) as srv:
        probes = [_x(5, 12, seed=210 + i) for i in range(3)]
        futs = [srv.submit(p) for p in probes]
        results = [f.result(timeout=WAIT) for f in futs]
        for p, res in zip(probes, results):
            np.testing.assert_array_equal(res.value, _ref_dense(p, corpus))
        assert srv.stats()["batches"] >= 2
        for res in results:
            assert res.stats["batch_rows"] <= 8


# -- significance on the cached null state ---------------------------------------------


def test_server_significance_matches_reference_on_its_permutations(corpus):
    """srv.significance against the reference server's, fed the
    reference's own permutation rows through PermutationSpec(indices=):
    r within 3e-6, p equal except at counted float64 near-ties (a replica
    whose |r| lies within 2e-5 of the observed one may count either way
    in float32); the port's answer is bitwise its corr(pvalues=), and a
    repeat is served from the cached null state."""
    import jax

    from repro.core import significance as ref_significance
    from repro.core.significance import PermutationSpec as RefSpec
    from repro.serving import CorrServer as RefCorrServer
    from repro_torch.core.significance import PermutationSpec

    B, key, chunk = 12, 5, 5
    probes = _x(6, 12, seed=230)
    cx = corpus.x.numpy()
    keys = ref_significance.iteration_keys(RefSpec(iterations=B, key=key))
    idx = np.asarray(jax.vmap(lambda k: jax.random.permutation(k, 12))(
        keys), np.int64)
    with RefCorrServer(jnp.asarray(cx), t=T, l_blk=LBLK) as ref:
        r_ref, p_ref = (np.asarray(a) for a in ref.significance(
            jnp.asarray(probes), pvalues=RefSpec(iterations=B, key=key,
                                                 chunk=chunk)).value)
    spec = PermutationSpec(B, indices=idx, chunk=chunk)
    with CorrServer(corpus, max_wait_s=0.0, **KW) as srv:
        first = srv.significance(probes, pvalues=spec)
        again = srv.significance(probes, pvalues=spec)
        built = srv.corpus.stats()["null_chunks"]
    r, p = first.value
    assert not first.stats["null_state_hit"] and again.stats["null_state_hit"]
    assert built == first.stats["replica_chunks"] == 3
    want_r, want_p = corr(probes, corpus.x, pvalues=spec, **KW)
    assert torch.equal(r, want_r) and torch.equal(p, want_p)
    assert torch.equal(again.value[0], r) and torch.equal(again.value[1], p)
    np.testing.assert_allclose(r.numpy(), r_ref, rtol=0, atol=ATOL)
    # float64 near-ties of the same replicas
    def z(a):
        c = a - a.mean(axis=1, keepdims=True)
        return c / np.linalg.norm(c, axis=1, keepdims=True)
    u, v = z(probes.astype(np.float64)), z(cx.astype(np.float64))
    obs = np.abs(np.clip(u @ v.T, -1, 1))
    ties = sum((np.abs(np.abs(np.clip(u @ v[:, row].T, -1, 1)) - obs)
                <= 2e-5).astype(int) for row in idx)
    d = np.rint(np.abs(p.numpy().astype(np.float64) - p_ref) * (B + 1))
    assert np.all(d <= ties)
    np.testing.assert_array_equal(p.numpy()[ties == 0], p_ref[ties == 0])


def test_serving_exports_the_reference_names():
    import repro.serving as ref_serving
    import repro_torch.serving as serving
    assert sorted(serving.__all__) == sorted(ref_serving.__all__)
    assert len(serving.__all__) == 23
    for name in serving.__all__:
        assert getattr(serving, name) is not None, name
