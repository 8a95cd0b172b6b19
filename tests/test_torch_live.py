"""Live corpora of the port (repro_torch.serving: live.py and the corpus
and server hooks) against repro.serving on the CPU, case for case with
tests/test_live.py: running moments (seed and delta merge) within the
pinned drift bound and bitwise after an exact refresh, delta-aware
execution (an append of d rows launches only the d-vs-n grid and the
d-vs-d triangle, spied at the executor's launch seam, and is bitwise a
cold run), generations, standing-query revalidation and push,
multi-corpus routing and the rank-measure warn-and-re-transform guard.

Tolerances: the port against itself is bitwise where the reference is
(appends, refreshes, a cold rebuild); maintained results within DRIFT_TOL
(1e-3) of a cold corr(), as the reference holds them; against the
reference, moments within 1e-5 relative and results within DRIFT_TOL,
top-k indices exact.  Every server is closed by a context manager and
every wait is bounded (<= 30 s).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

import repro_torch.core.allpairs as allpairs
from repro.core.plan import prepare_operand_raw as ref_prepare
from repro.serving import CorpusHandle as RefCorpusHandle
from repro.serving import LiveIndex as RefLiveIndex
from repro.serving import merge_row_moments as ref_merge
from repro.serving import row_moments as ref_row_moments
from repro.serving import supports_incremental as ref_supports
from repro.serving import topk_rows_from_dense as ref_topk_rows
from repro_torch.core import measures
from repro_torch.core.api import corr
from repro_torch.core.mapping import GridWorkload, TriangularWorkload
from repro_torch.core.plan import prepare_operand_raw, take_operand_rows
from repro_torch.core.sinks import TopKSink, topk_merge_rows
from repro_torch.serving import (DRIFT_TOL, CorpusHandle, CorrServer,
                                 IncrementalOperand, LiveIndex,
                                 merge_row_moments, row_moments,
                                 supports_incremental, topk_rows_from_dense)

KW = dict(t=8, l_blk=8, device="cpu")
WAIT = 30


def _x(n, l, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, l)).astype(np.float32)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _mutate(handles, rng, steps, l):
    """Drive `steps` mixed append / update cycles on every handle alike;
    return the final corpus as independent numpy ground truth."""
    ref = _np(handles[0].x).copy()
    for _ in range(steps):
        if rng.random() < 0.5:
            d = rng.standard_normal(
                (int(rng.integers(1, 7)), l)).astype(np.float32)
            for h in handles:
                h.append(d)
            ref = np.concatenate([ref, d])
        else:
            k = int(rng.integers(1, min(5, ref.shape[0] + 1)))
            idx = np.sort(rng.choice(ref.shape[0], size=k, replace=False))
            rows = rng.standard_normal((k, l)).astype(np.float32)
            for h in handles:
                h.update(idx, rows)
            ref[idx] = rows
    return ref


# -- running moments ------------------------------------------------------------------


def test_row_moments_match_direct():
    x = _x(9, 13, seed=1)
    mean, m2 = map(_np, row_moments(x))
    np.testing.assert_allclose(mean, x.mean(axis=1), rtol=1e-6)
    np.testing.assert_allclose(
        m2, ((x - x.mean(axis=1, keepdims=True)) ** 2).sum(axis=1),
        rtol=1e-5, atol=1e-5)
    rmean, rm2 = map(np.asarray, ref_row_moments(jnp.asarray(x)))
    np.testing.assert_allclose(mean, rmean, rtol=1e-6)
    np.testing.assert_allclose(m2, rm2, rtol=1e-5, atol=1e-6)


def test_merge_row_moments_matches_recompute():
    old = _x(6, 17, seed=2)
    new = _x(6, 17, seed=3)
    mean, m2 = row_moments(old)
    mean2, m22 = map(_np, merge_row_moments(mean, m2, old, new))
    ref_mean, ref_m2 = map(_np, row_moments(new))
    np.testing.assert_allclose(mean2, ref_mean, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(m22, ref_m2, rtol=1e-3, atol=1e-3)
    # the reference's merge, in the same order of float32 operations
    rmean, rm2 = ref_row_moments(jnp.asarray(old))
    wmean, wm2 = map(np.asarray, ref_merge(rmean, rm2, jnp.asarray(old),
                                           jnp.asarray(new)))
    np.testing.assert_allclose(mean2, wmean, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(m22, wm2, rtol=1e-5, atol=1e-5)


def test_supports_incremental_by_measure():
    for name in ("pearson", "cosine", "covariance", "dot"):
        assert supports_incremental(measures.get(name), None), name
        assert measures.get(name).incremental
    for name in ("spearman", "kendall", "kendall_tau_b", "kendall_merge"):
        assert not supports_incremental(measures.get(name), None), name
    # quantized dtypes need per-row scales: no incremental path
    assert not supports_incremental(measures.get("pearson"), torch.int8)
    assert supports_incremental(measures.get("pearson"), torch.float16)
    from repro.core import measures as ref_measures
    for name in ("pearson", "cosine", "spearman", "kendall"):
        assert supports_incremental(measures.get(name), None) == \
            ref_supports(ref_measures.get(name), None)


def test_incremental_operand_append_update_refresh():
    meas = measures.get("pearson")
    x = _x(10, 12, seed=4)
    st_ = IncrementalOperand(torch.from_numpy(x), meas, None, 8, 8)
    d = _x(3, 12, seed=5)
    st_.append(torch.from_numpy(d))
    x = np.concatenate([x, d])
    idx = np.array([1, 11])
    rows = _x(2, 12, seed=6)
    st_.update(idx, torch.from_numpy(x[idx]), torch.from_numpy(rows))
    x[idx] = rows
    cold = prepare_operand_raw(torch.from_numpy(x), meas, None, 8, 8)
    np.testing.assert_allclose(_np(st_.operand), _np(cold), rtol=1e-5,
                               atol=1e-5)
    assert st_.update_batches == 1
    st_.refresh(torch.from_numpy(x))
    assert torch.equal(st_.operand, cold)
    assert st_.update_batches == 0
    # the reference's cold operand of the same corpus
    from repro.core import measures as ref_measures
    np.testing.assert_allclose(_np(cold), np.asarray(ref_prepare(
        jnp.asarray(x), ref_measures.get("pearson"), None, 8, 8)),
        rtol=0, atol=3e-6)


def test_incremental_operand_rejects_rank_measures():
    with pytest.raises(ValueError, match="no incremental"):
        IncrementalOperand(torch.from_numpy(_x(8, 10)),
                           measures.get("kendall"), None, 8, 8)


# -- drift: a pinned bound between incremental cycles and a cold transform -------------


@given(st.integers(0, 2 ** 31 - 1))
@settings(max_examples=5, deadline=None)
def test_property_drift_bounded_over_cycles(seed):
    rng = np.random.default_rng(seed)
    h = CorpusHandle(_x(12, 10, seed=seed % 997), **KW)
    li = LiveIndex(h, measure="pearson")
    ref = _mutate([h], rng, steps=6, l=10)
    live = li.result()
    cold = corr(ref, **KW).numpy()
    assert np.abs(live["r"] - cold).max() <= DRIFT_TOL
    assert live["generation"] == h.generation == 6
    li.close()


def test_exact_refresh_restores_bit_identity():
    h = CorpusHandle(_x(16, 12, seed=7), drift_budget=3, **KW)
    _ = h.operand("pearson")
    rng = np.random.default_rng(8)
    for _ in range(3):
        idx = np.sort(rng.choice(h.n, size=2, replace=False))
        h.update(idx, rng.standard_normal((2, 12)).astype(np.float32))
    st_ = h.stats()
    assert st_["refreshes"] == 1
    assert st_["live"]["pearson/None"]["update_batches"] == 0
    cold = prepare_operand_raw(h.x, measures.get("pearson"), None, 8, 8)
    assert torch.equal(h.operand("pearson"), cold)
    h.update(np.array([0]), rng.standard_normal((1, 12)).astype(np.float32))
    h.refresh()
    cold = prepare_operand_raw(h.x, measures.get("pearson"), None, 8, 8)
    assert torch.equal(h.operand("pearson"), cold)


def test_append_is_bit_identical_to_cold():
    """Appends only seed fresh moments (no merge): the extended operand and
    the standing dense result are bitwise a cold run's; the reference's
    standing result agrees within 3e-6."""
    x0 = _x(20, 12, seed=9)
    h = CorpusHandle(x0, **KW)
    li = LiveIndex(h, measure="pearson")
    d = _x(5, 12, seed=10)
    h.append(d)
    full = np.concatenate([x0, d])
    cold_u = prepare_operand_raw(torch.from_numpy(full),
                                 measures.get("pearson"), None, 8, 8)
    assert torch.equal(h.operand("pearson"), cold_u)
    assert np.array_equal(li.result()["r"], corr(full, **KW).numpy())
    rh = RefCorpusHandle(jnp.asarray(x0), t=8, l_blk=8)
    rli = RefLiveIndex(rh, measure="pearson")
    rh.append(jnp.asarray(d))
    np.testing.assert_allclose(li.result()["r"], rli.result()["r"], rtol=0,
                               atol=3e-6)


# -- delta-aware execution: only the delta tiles launch -----------------------------


def _spy_launches(monkeypatch):
    launches = []
    orig = allpairs.launch_tiles

    def spy(plan, u, j0, launch, v=None):
        launches.append(plan.workload)
        return orig(plan, u, j0, launch, v=v)

    monkeypatch.setattr(allpairs, "launch_tiles", spy)
    return launches


def test_append_launches_only_delta_tiles(monkeypatch):
    h = CorpusHandle(_x(40, 12, seed=11), **KW)
    li = LiveIndex(h, measure="pearson")
    launches = _spy_launches(monkeypatch)
    h.append(_x(6, 12, seed=12))
    kinds = [type(w).__name__ for w in launches]
    assert kinds == ["GridWorkload", "TriangularWorkload"]
    grid, tri = launches
    assert grid == GridWorkload(1, 5)            # ceil(6/8) x ceil(40/8)
    assert tri == TriangularWorkload(1)          # ceil(6/8) triangle
    delta_tiles = grid.job_count + tri.job_count
    full_tiles = TriangularWorkload(-(-46 // 8)).job_count
    assert delta_tiles < full_tiles
    li.close()


def test_update_launches_only_delta_grid(monkeypatch):
    h = CorpusHandle(_x(40, 12, seed=13), **KW)
    li = LiveIndex(h, measure="pearson")
    launches = _spy_launches(monkeypatch)
    h.update(np.array([3, 17]), _x(2, 12, seed=14))
    assert [type(w).__name__ for w in launches] == ["GridWorkload"]
    assert launches[0] == GridWorkload(1, 5)
    li.close()


def test_live_index_topk_matches_cold_over_cycles():
    rng = np.random.default_rng(15)
    x0 = _x(20, 12, seed=15)
    h = CorpusHandle(x0, **KW)
    rh = RefCorpusHandle(jnp.asarray(x0), t=8, l_blk=8)
    li = LiveIndex(h, measure="pearson", k=3)
    rli = RefLiveIndex(rh, measure="pearson", k=3)
    ref = _mutate([h, rh], rng, steps=5, l=12)
    cold = corr(ref, sink=TopKSink(3), **KW)
    live = li.result()
    assert np.array_equal(live["indices"], cold["indices"])
    assert np.abs(live["values"] - cold["values"]).max() <= DRIFT_TOL
    assert live["generation"] == h.generation
    want = rli.result()
    assert np.array_equal(live["indices"], want["indices"])
    assert np.abs(live["values"] - want["values"]).max() <= DRIFT_TOL


def test_live_index_delta_recovery_composes():
    """recovery= composes with the delta passes in both packages: the
    transient fault at the append's first launch fires in each, is retried,
    and the index is bitwise a cold corr of the grown corpus (and within
    3e-6 of the reference's)."""
    from repro.runtime.faults import FaultPlan as RefFaultPlan
    from repro.runtime.faults import RetryPolicy as RefRetryPolicy
    from repro_torch.runtime.faults import FaultPlan, RetryPolicy
    rh = RefCorpusHandle(jnp.asarray(_x(16, 12, seed=16)), t=8, l_blk=8)
    ref_pol = RefRetryPolicy(sleep=lambda s: None)
    rli = RefLiveIndex(rh, measure="pearson", recovery=ref_pol,
                       max_tiles_per_pass=2)
    ref_plan = RefFaultPlan.single("pass_launch", "transient", at=1)
    with ref_plan.armed():
        rh.append(jnp.asarray(_x(5, 12, seed=17)))
    h = CorpusHandle(_x(16, 12, seed=16), **KW)
    pol = RetryPolicy(sleep=lambda s: None)
    li = LiveIndex(h, measure="pearson", recovery=pol, max_tiles_per_pass=2)
    plan = FaultPlan.single("pass_launch", "transient", at=1)
    with plan.armed():
        h.append(_x(5, 12, seed=17))
    assert plan.fired == ref_plan.fired == [("pass_launch", 1, "transient")]
    assert pol.log == ref_pol.log
    assert [e["action"] for e in pol.log] == ["retry"]
    got = li.result()["r"]
    assert np.array_equal(got, corr(h.x, **KW).numpy())
    np.testing.assert_allclose(got, rli.result()["r"], rtol=0, atol=3e-6)


def test_live_index_rebuild_matches_cold():
    h = CorpusHandle(_x(12, 10, seed=18), **KW)
    li = LiveIndex(h, measure="pearson")
    _mutate([h], np.random.default_rng(19), steps=4, l=10)
    li.rebuild()
    assert np.array_equal(li.result()["r"], corr(h.x, **KW).numpy())
    assert li.result()["generation"] == h.generation
    li.close()


def test_live_index_close_stops_tracking():
    h = CorpusHandle(_x(10, 10, seed=20), **KW)
    li = LiveIndex(h, measure="pearson")
    li.close()
    h.append(_x(2, 10, seed=21))
    assert li.result()["generation"] == 0


# -- generations ------------------------------------------------------------------------


def test_generation_versioning():
    h = CorpusHandle(_x(10, 10, seed=22), **KW)
    rh = RefCorpusHandle(jnp.asarray(_x(10, 10, seed=22)), t=8, l_blk=8)
    assert h.generation == 0
    d1 = h.append(_x(2, 10, seed=23))
    r1 = rh.append(jnp.asarray(_x(2, 10, seed=23)))
    assert (d1.generation, d1.kind, d1.lo, d1.hi) == (1, "append", 10, 12)
    assert (d1.generation, d1.kind, d1.lo, d1.hi, d1.count) == \
        (r1.generation, r1.kind, r1.lo, r1.hi, r1.count)
    d2 = h.update(np.array([0]), _x(1, 10, seed=24))
    assert (d2.generation, d2.kind) == (2, "update")
    assert d2.count == 1
    assert h.generation == 2
    assert h.stats()["generation"] == 2


def test_served_results_name_generation():
    with CorrServer(_x(16, 12, seed=25), max_wait_s=0.0, **KW) as srv:
        probes = _x(2, 12, seed=26)
        r0 = srv.query(probes, timeout=WAIT)
        assert r0.stats["corpus_generation"] == 0
        assert r0.stats["corpus"] == "default"
        srv.corpus.append(_x(3, 12, seed=27))
        r1 = srv.query(probes, timeout=WAIT)
        assert r1.stats["corpus_generation"] == 1
        assert r1.value.shape == (2, 19)
        np.testing.assert_array_equal(r1.value,
                                      corr(probes, srv.corpus.x, **KW).numpy())


# -- standing queries (server.watch) -------------------------------------------------


def test_watch_initial_snapshot_matches_cold():
    x0 = _x(24, 12, seed=28)
    with CorrServer(x0, max_wait_s=0.0, **KW) as srv:
        probes = _x(3, 12, seed=29)
        w = srv.watch(probes, 3)
        cold = corr(probes, srv.corpus.x, sink=TopKSink(3), **KW)
        cur = w.current()
        assert np.array_equal(cur["indices"], cold["indices"])
        np.testing.assert_array_equal(cur["values"], cold["values"])
        assert cur["generation"] == 0
    from repro.core.api import corr as ref_corr
    from repro.core.sinks import TopKSink as RefTopKSink
    want = ref_corr(jnp.asarray(probes), jnp.asarray(x0), t=8, l_blk=8,
                    sink=RefTopKSink(3))
    assert np.array_equal(cur["indices"], np.asarray(want["indices"]))


def test_watch_revalidates_and_pushes_on_append():
    pushes = []
    with CorrServer(_x(24, 12, seed=30), max_wait_s=0.0, **KW) as srv:
        probes = _x(3, 12, seed=31)
        w = srv.watch(probes, 3, callback=pushes.append)
        strong = (probes[0:1] * 2.0 + 0.01).astype(np.float32)
        srv.corpus.append(np.concatenate([strong, _x(2, 12, seed=32)]))
        srv.flush_watches(timeout=WAIT)
        cold = corr(probes, srv.corpus.x, sink=TopKSink(3), **KW)
        cur = w.current()
        assert np.array_equal(cur["indices"], cold["indices"])
        assert np.array_equal(cur["values"], cold["values"])
        assert cur["indices"][0, 0] == 24
        assert cur["generation"] == 1
        assert len(pushes) == 1 and pushes[0]["generation"] == 1
        assert np.array_equal(pushes[0]["indices"], cur["indices"])
        st_ = srv.stats()["watches"]
        assert st_ == {"count": 1, "revalidations": 1, "pushes": 1}


def test_watch_update_of_kept_column_recomputes_exactly():
    pushes = []
    with CorrServer(_x(24, 12, seed=33), max_wait_s=0.0, **KW) as srv:
        probes = _x(3, 12, seed=34)
        w = srv.watch(probes, 3, callback=pushes.append)
        kept = int(w.current()["indices"][0, 0])
        srv.corpus.update(np.array([kept]), _x(1, 12, seed=35))
        srv.flush_watches(timeout=WAIT)
        cold = corr(probes, srv.corpus.x, sink=TopKSink(3), **KW)
        cur = w.current()
        assert np.array_equal(cur["indices"], cold["indices"])
        assert np.abs(cur["values"] - cold["values"]).max() <= DRIFT_TOL
        assert cur["generation"] == 1


def test_watch_no_push_when_kept_set_unchanged():
    pushes = []
    with CorrServer(_x(24, 12, seed=36), max_wait_s=0.0, **KW) as srv:
        probes = _x(2, 12, seed=37)
        w = srv.watch(probes, 2, callback=pushes.append)
        before = w.current()
        weak = np.zeros((2, 12), np.float32)
        weak[:, 0] = 1e-6
        srv.corpus.append(weak)
        srv.flush_watches(timeout=WAIT)
        cur = w.current()
        assert cur["generation"] == 1
        assert w.revalidations == 1
        if np.array_equal(before["indices"], cur["indices"]):
            assert pushes == []


def test_slow_watch_callback_does_not_stall_ingest():
    """Revalidation runs on the dispatcher thread: a slow callback adds
    nothing to append() latency, and generations still arrive in order.
    The callback blocks on an event rather than a clock, so the check does
    not depend on timing."""
    import threading

    gate = threading.Event()
    gens = []

    def slow(snap):
        gate.wait(WAIT)
        gens.append(snap["generation"])

    with CorrServer(_x(24, 12, seed=60), max_wait_s=0.0, **KW) as srv:
        probes = _x(2, 12, seed=61)
        w = srv.watch(probes, 2, callback=slow)
        srv.corpus.append(_x(1, 12, seed=64))
        for i in range(2):
            # each append correlates ~1.0 with probe 0: the kept set moves
            srv.corpus.append(
                (probes[0:1] * (2.0 + i) + 0.01 * (i + 1)).astype(np.float32))
        # all three mutations returned while the first callback was blocked
        assert srv.corpus.generation == 3
        gate.set()
        srv.flush_watches(timeout=WAIT)
        assert w.generation == 3
        assert gens and gens == sorted(gens)
        cold = corr(probes, srv.corpus.x, sink=TopKSink(2), **KW)
        assert np.array_equal(w.current()["indices"], cold["indices"])


def test_watch_callback_error_counted_not_propagated():
    def bad(snap):
        raise RuntimeError("boom")

    with CorrServer(_x(16, 12, seed=62), max_wait_s=0.0, **KW) as srv:
        probes = _x(2, 12, seed=63)
        srv.watch(probes, 2, callback=bad)
        strong = (probes[0:1] * 2.0 + 0.01).astype(np.float32)
        srv.corpus.append(strong)            # must not raise
        srv.flush_watches(timeout=WAIT)
        assert srv.stats()["faults"]["watch_errors"] == 1
        r = srv.query(probes, timeout=WAIT)
        assert r.value.shape == (2, 17)


def test_unwatch_stops_revalidation():
    with CorrServer(_x(16, 12, seed=38), max_wait_s=0.0, **KW) as srv:
        w = srv.watch(_x(2, 12, seed=39), 2)
        srv.unwatch(w)
        srv.corpus.append(_x(2, 12, seed=40))
        srv.flush_watches(timeout=WAIT)
        assert w.current()["generation"] == 0
        assert srv.stats()["watches"]["count"] == 0


# -- multi-corpus routing -------------------------------------------------------------


def test_multi_corpus_routing_and_stats():
    xa, xb = _x(16, 12, seed=41), _x(12, 10, seed=42)
    with CorrServer(xa, max_wait_s=0.0, **KW) as srv:
        srv.add_corpus("b", xb)
        assert srv.corpora() == ["b", "default"]
        pa = _x(2, 12, seed=43)
        pb = _x(2, 10, seed=44)
        ra = srv.query(pa, timeout=WAIT)
        rb = srv.query(pb, corpus="b", k=4, timeout=WAIT)
        np.testing.assert_array_equal(ra.value, corr(pa, xa, **KW).numpy())
        cold_b = corr(pb, xb, sink=TopKSink(4), **KW)
        np.testing.assert_array_equal(rb.value["indices"], cold_b["indices"])
        assert ra.stats["corpus"] == "default"
        assert rb.stats["corpus"] == "b"
        st_ = srv.stats()
        assert sorted(st_["corpora"]) == ["b", "default"]
        assert st_["corpora"]["b"]["rows"] == 12
        with pytest.raises(ValueError, match="corpus has l=10"):
            srv.submit(pa, corpus="b").result(timeout=WAIT)
        with pytest.raises(ValueError, match="unknown corpus"):
            srv.submit(pa, corpus="nope")
        with pytest.raises(ValueError, match="already registered"):
            srv.add_corpus("b", xb)


def test_multi_corpus_batch_partitions_per_corpus():
    xa, xb = _x(16, 12, seed=45), _x(12, 12, seed=46)
    with CorrServer(xa, max_wait_s=0.05, max_batch_rows=4096, **KW) as srv:
        srv.add_corpus("b", xb)
        pa, pb = _x(2, 12, seed=47), _x(2, 12, seed=48)
        fa = srv.submit(pa)
        fb = srv.submit(pb, corpus="b")
        np.testing.assert_array_equal(fa.result(timeout=WAIT).value,
                                      corr(pa, xa, **KW).numpy())
        np.testing.assert_array_equal(fb.result(timeout=WAIT).value,
                                      corr(pb, xb, **KW).numpy())
        assert fa.result().value.shape == (2, 16)
        assert fb.result().value.shape == (2, 12)


def test_watch_routes_per_corpus():
    xa, xb = _x(16, 12, seed=49), _x(12, 12, seed=50)
    with CorrServer(xa, max_wait_s=0.0, **KW) as srv:
        hb = srv.add_corpus("b", xb)
        w = srv.watch(_x(2, 12, seed=51), 2, corpus="b")
        assert w.current()["corpus"] == "b"
        srv.corpus.append(_x(2, 12, seed=52))
        srv.flush_watches(timeout=WAIT)
        assert w.current()["generation"] == 0
        hb.append(_x(2, 12, seed=53))
        srv.flush_watches(timeout=WAIT)
        assert w.current()["generation"] == 1


# -- rank-measure guard: warn once, re-transform exactly ------------------------------


def test_rank_measure_mutation_warns_once_and_retransforms():
    h = CorpusHandle(_x(12, 10, seed=54), **KW)
    _ = h.operand("kendall")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        h.append(_x(2, 10, seed=55))
        h.append(_x(2, 10, seed=56))             # the second is silent
    msgs = [str(x.message) for x in w
            if "no incremental" in str(x.message)]
    assert len(msgs) == 1 and "'kendall'" in msgs[0]
    cold = prepare_operand_raw(h.x, measures.get("kendall"), None, 8, 8)
    assert torch.equal(h.operand("kendall"), cold)
    probes = _x(2, 10, seed=57)
    with CorrServer(h, max_wait_s=0.0, **KW) as srv:
        got = srv.query(probes, measure="kendall", timeout=WAIT)
        np.testing.assert_array_equal(
            got.value, corr(probes, h.x, measure="kendall", **KW).numpy())


def test_moment_measures_do_not_warn():
    h = CorpusHandle(_x(12, 10, seed=58), **KW)
    _ = h.operand("pearson")
    _ = h.operand("cosine")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        h.append(_x(2, 10, seed=59))
    assert not [x for x in w if "no incremental" in str(x.message)]


# -- mutation validation and helpers -------------------------------------------------


def test_mutation_validation():
    h = CorpusHandle(_x(8, 10, seed=60), **KW)
    with pytest.raises(ValueError, match="must be"):
        h.append(_x(2, 9, seed=61))
    with pytest.raises(ValueError, match="empty"):
        h.append(np.zeros((0, 10), np.float32))
    with pytest.raises(ValueError, match="unique"):
        h.update(np.array([1, 1]), _x(2, 10, seed=62))
    with pytest.raises(ValueError, match="out of range"):
        h.update(np.array([8]), _x(1, 10, seed=63))
    with pytest.raises(ValueError, match="entries for"):
        h.update(np.array([1]), _x(2, 10, seed=64))
    assert h.generation == 0


def test_take_operand_rows_slices_and_repads():
    u = torch.arange(24, dtype=torch.float32).reshape(6, 4)
    out = take_operand_rows(u, slice(2, 5), 8)
    assert tuple(out.shape) == (8, 4)
    assert torch.equal(out[:3], u[2:5])
    assert bool((out[3:] == 0).all())
    with pytest.raises(ValueError, match="more than n_pad"):
        take_operand_rows(u, slice(0, 6), 4)
    from repro.core.plan import take_operand_rows as ref_take
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(ref_take(jnp.asarray(u.numpy()),
                                         slice(2, 5), 8)))
    from repro_torch.core.quantize import Operand
    q = Operand(u.to(torch.int8), torch.arange(6, dtype=torch.float32))
    qo = take_operand_rows(q, torch.tensor([4, 1]), 8)
    assert qo.scale.tolist() == [4.0, 1.0] + [0.0] * 6


def test_topk_rows_from_dense_matches_sink_order():
    rng = np.random.default_rng(65)
    scores = rng.standard_normal((5, 9)).astype(np.float32)
    vals, idx = topk_rows_from_dense(scores, 3)
    rv = np.zeros((5, 3), np.float32)
    ri = np.full((5, 3), -1, np.int64)
    for j in range(9):
        topk_merge_rows(rv, ri, np.arange(5), np.full(5, j), scores[:, j], 3)
    np.testing.assert_array_equal(idx, ri)
    np.testing.assert_array_equal(vals, rv)
    vals2, idx2 = topk_rows_from_dense(scores, 3, exclude_cols=np.arange(5))
    for r in range(5):
        assert r not in idx2[r]
    wv, wi = ref_topk_rows(scores, 3, exclude_cols=np.arange(5))
    np.testing.assert_array_equal(idx2, wi)
    np.testing.assert_array_equal(vals2, wv)
