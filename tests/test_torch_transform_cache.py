"""The operand transform cache of the port (core/lru.py LruStatsCache,
api.TransformCache, prepared_operand and the process-wide cache corr()
uses) against repro.core's, on the CPU.

The cache must never change a result: every cached run is bitwise the
uncached one.  Unlike a jax array, a torch tensor can change in place, so
the key holds the tensor's version counter: a changed tensor misses and
gives the new result.
"""

import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as ref_api
from repro.core import measures as ref_measures
from repro_torch.core import api, measures
from repro_torch.core.api import (PairwiseProblem, TransformCache, corr,
                                  prepared_operand)
from repro_torch.core.lru import LruStatsCache
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.quantize import Operand, fp8_supported
from repro_torch.core.sinks import TopKSink

T, LBLK = 8, 8
KW = dict(t=T, l_blk=LBLK, max_tiles_per_pass=4, device="cpu")


def _x(n, l, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, l)).astype(np.float32)


@pytest.fixture(autouse=True)
def _fresh_cache():
    api.clear_prepared_cache()
    ref_api.clear_prepared_cache()
    yield
    api.clear_prepared_cache()
    ref_api.clear_prepared_cache()


def _zeros():
    return torch.zeros((8, 8))


def test_lru_counts_and_evicts_like_the_reference():
    from repro.core.lru import LruStatsCache as RefLru
    caches = [LruStatsCache(2), RefLru(2)]
    for c in caches:
        for k in "abc":
            c._insert(k, k.upper())
        assert c._lookup("a") is None and c._lookup("c") == "C"
        c._evict("b")
        c._evict("zz")
    assert caches[0].stats() == caches[1].stats() == {
        "hits": 1, "misses": 3, "size": 1, "capacity": 2}
    for cls in (LruStatsCache, TransformCache):
        with pytest.raises(ValueError, match="capacity"):
            cls(0)


def test_transform_cache_lru_and_identity_guard():
    """The reference's test_transform_cache_lru_and_identity_guard, with
    tensors for jax arrays."""
    cache = TransformCache(capacity=2)
    meas = measures.get("pearson")
    xs = [torch.from_numpy(_x(8, 8, seed=s)) for s in range(3)]
    for x in xs:
        cache.prepared(x, meas, None, T, LBLK, build=_zeros)
    assert len(cache) == 2 and cache.misses == 3
    # the oldest was evicted: preparing it again is a miss
    cache.prepared(xs[0], meas, None, T, LBLK, build=_zeros)
    assert cache.misses == 4
    # the newest two hit, and return the cached object
    hit = cache.prepared(xs[0], meas, None, T, LBLK,
                         build=lambda: pytest.fail("rebuilt on a hit"))
    assert cache.hits == 1 and hit.shape == (8, 8)
    # numpy operands bypass the cache entirely
    cache.prepared(_x(8, 8), meas, None, T, LBLK, build=_zeros)
    assert cache.stats() == {"hits": 1, "misses": 4, "size": 2,
                             "capacity": 2}
    # another measure is another key
    cache.prepared(xs[0], measures.get("spearman"), None, T, LBLK,
                   build=_zeros)
    assert cache.misses == 5


def test_key_normalises_compute_dtype():
    x = torch.zeros(4, 4)
    meas = measures.get("pearson")
    key = TransformCache._key
    assert key(x, meas, torch.bfloat16, T, LBLK) == \
        key(x, meas, "bfloat16", T, LBLK)
    assert key(x, meas, torch.int8, T, LBLK) != \
        key(x, meas, torch.bfloat16, T, LBLK)
    assert key(x, meas, None, T, LBLK) != key(x, meas, None, 2 * T, LBLK)
    cache = TransformCache()
    cache.prepared(x, meas, torch.bfloat16, T, LBLK, build=_zeros)
    cache.prepared(x, meas, "bfloat16", T, LBLK, build=_zeros)
    assert (cache.hits, cache.misses) == (1, 1)


def test_entries_die_with_their_operand():
    """The cache never extends an operand's lifetime: dropping the tensor
    evicts its entry (weakref death callback), as in the reference."""
    x = torch.from_numpy(_x(16, 10, seed=8))
    corr(x, **KW)
    assert api.prepared_cache_stats()["size"] == 1
    del x
    gc.collect()
    assert api.prepared_cache_stats()["size"] == 0
    xr = jnp.asarray(_x(16, 10, seed=8))
    ref_api.corr(xr, t=T, l_blk=LBLK)
    assert ref_api.prepared_cache_stats()["size"] == 1
    del xr
    gc.collect()
    assert ref_api.prepared_cache_stats()["size"] == 0


def test_numpy_inputs_do_not_pollute_cache():
    """Host numpy converts to a fresh tensor per call: uncached, in both
    packages."""
    xh, yh = _x(12, 10, seed=6), _x(9, 10, seed=7)
    for mod, c in ((api, lambda *a: corr(*a, **KW)),
                   (ref_api, lambda *a: ref_api.corr(*a, t=T,
                                                     l_blk=LBLK))):
        c(xh)
        c(xh)
        c(xh, yh)
        assert mod.prepared_cache_stats() == {
            "hits": 0, "misses": 0, "size": 0, "capacity": 8}


def test_repeat_call_hits_and_is_bitwise():
    x = torch.from_numpy(_x(37, 29, seed=1))
    first = corr(x, measure="spearman", **KW)
    assert api.prepared_cache_stats() == {"hits": 0, "misses": 1, "size": 1,
                                          "capacity": 8}
    second = corr(x, measure="spearman", **KW)
    assert api.prepared_cache_stats()["hits"] == 1
    assert api.prepared_cache_stats()["misses"] == 1
    assert torch.equal(first, second)
    # the reference counts the same on the same calls
    xr = jnp.asarray(_x(37, 29, seed=1))
    ref_api.corr(xr, measure="spearman", t=T, l_blk=LBLK)
    ref_api.corr(xr, measure="spearman", t=T, l_blk=LBLK)
    assert ref_api.prepared_cache_stats() == api.prepared_cache_stats()


def test_in_place_change_misses_and_follows():
    """x changed in place between two calls: the second is a miss and gives
    the result of the changed x (the entry of the old version is dropped,
    not pinned)."""
    x = torch.from_numpy(_x(37, 29, seed=2))
    before = corr(x, measure="spearman", **KW)
    x[0, :5] += torch.arange(5, dtype=torch.float32) * 3
    after = corr(x, measure="spearman", **KW)
    stats = api.prepared_cache_stats()
    assert (stats["hits"], stats["misses"], stats["size"]) == (0, 2, 1)
    assert not torch.equal(before, after)
    api.clear_prepared_cache()
    assert torch.equal(after, corr(x.clone(), measure="spearman", **KW))
    assert torch.equal(after, corr(x.numpy().copy(), measure="spearman",
                                   **KW))
    # a view's in-place change bumps the base's counter too
    v = x[1]
    corr(x, **KW)
    v.mul_(2)
    corr(x, **KW)
    assert api.prepared_cache_stats()["hits"] == 0


def test_writes_behind_torch_need_a_clear():
    """A write through a numpy view does not move the version counter, so
    the cache cannot see it (the documented limit); clear_prepared_cache()
    brings the new result."""
    a = _x(37, 29, seed=9)
    x = torch.from_numpy(a)
    before = corr(x, **KW)
    a[0, :5] += 3.0
    assert torch.equal(corr(x, **KW), before)
    api.clear_prepared_cache()
    after = corr(x, **KW)
    assert not torch.equal(after, before)
    assert torch.equal(after, corr(a.copy(), **KW))


MODES = [("pearson", None), ("spearman", None), ("cosine", None),
         ("covariance", None), ("pearson", torch.bfloat16),
         ("pearson", "int8"), ("kendall", torch.int8)] + (
    [("pearson", torch.float8_e4m3fn)] if fp8_supported("float8_e4m3fn")
    else [])


@pytest.mark.parametrize("measure,dtype", MODES)
def test_cached_runs_are_bitwise_uncached(measure, dtype):
    """Symmetric, rectangular and top-k runs through the cache (miss, then
    hit) give the bits of the uncached run from numpy; quantized runs cache
    the Operand itself."""
    xn, yn = _x(37, 29, seed=3), _x(21, 29, seed=4)
    x, y = torch.from_numpy(xn), torch.from_numpy(yn)
    kw = dict(KW, measure=measure, compute_dtype=dtype)
    want = corr(xn, **kw)
    want_xy = corr(xn, yn, **kw)
    want_top = corr(xn, sink=TopKSink(4), **kw)
    assert api.prepared_cache_stats()["size"] == 0
    for _ in range(2):
        assert torch.equal(corr(x, **kw), want)
        assert torch.equal(corr(x, y, **kw), want_xy)
        top = corr(x, sink=TopKSink(4), **kw)
        for key in ("indices", "values"):
            np.testing.assert_array_equal(top[key], want_top[key])
    stats = api.prepared_cache_stats()
    assert (stats["misses"], stats["hits"], stats["size"]) == (2, 6, 2)
    plan = ExecutionPlan.create(37, 29, t=T, l_blk=LBLK, measure=measure,
                                compute_dtype=dtype)
    cached = prepared_operand(plan, x)
    assert isinstance(cached, Operand) == plan.scaled


def test_prepared_operand_matches_reference_and_checks_shape():
    xn = _x(21, 13, seed=5)
    plan = ExecutionPlan.create(21, 13, t=T, l_blk=LBLK)
    x = torch.from_numpy(xn)
    got = prepared_operand(plan, x)
    assert got is prepared_operand(plan, x)
    assert torch.equal(got, prepared_operand(plan, x, cacheable=False))
    from repro.core.plan import ExecutionPlan as RefPlan
    ref = ref_api.prepared_operand(RefPlan.create(21, 13, t=T, l_blk=LBLK),
                                   jnp.asarray(xn))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=3e-6)
    # a column operand of another row count, through expect_rows
    y = torch.from_numpy(_x(9, 13, seed=6))
    assert prepared_operand(plan, y, expect_rows=9).shape == (16, 16)
    with pytest.raises(ValueError, match="does not match plan"):
        prepared_operand(plan, y)
    own = TransformCache(capacity=1)
    prepared_operand(plan, x, cache=own)
    assert own.stats()["misses"] == 1 and len(own) == 1


def test_problem_keeps_the_callers_tensor():
    x = torch.from_numpy(_x(10, 6))
    y = torch.from_numpy(_x(7, 6))
    prob = PairwiseProblem.create(x, y, device="cpu")
    assert prob.x is x and prob.y is y
    xd = x.double()
    assert PairwiseProblem.create(xd, device="cpu").x is xd
    assert PairwiseProblem.create(x.numpy(), device="cpu").x is not x


def test_masked_runs_and_shared_storage_are_uncached():
    xm = _x(18, 22, seed=7)
    xm[::5, ::3] = np.nan
    corr(torch.from_numpy(xm), where="nan", **KW)
    assert api.prepared_cache_stats()["size"] == 0
    # "dot" is the identity transform: with no padding the prepared operand
    # is the tensor itself, and an entry would keep it alive
    x = torch.from_numpy(_x(16, 16, seed=8))
    r = corr(x, measure="dot", **KW)
    assert api.prepared_cache_stats()["size"] == 0
    np.testing.assert_allclose(
        r.numpy(), np.asarray(ref_measures.dense_reference(
            jnp.asarray(x.numpy()), "dot")), atol=1e-5)


@pytest.mark.parametrize("measure,l", [("pearson", 29), ("kendall", 29),
                                       ("kendall", 100)])
@pytest.mark.parametrize("in_mode", [True, False])
def test_inference_tensors_run_uncached_with_the_same_bits(measure, l,
                                                           in_mode):
    """A tensor made under torch.inference_mode() has no version counter:
    corr builds its operand uncached (no entry), inside the mode and after
    it, and gives the bits of a normal tensor of the same values (kendall
    at l = 100 takes the merge-sort kernel, whose rank structures are
    rebuilt at each of the 4-tile passes)."""
    a = _x(37, l, seed=30)
    with torch.inference_mode():
        xi = torch.from_numpy(a.copy())
        if in_mode:
            got = corr(xi, measure=measure, **KW)
            again = corr(xi, measure=measure, **KW)
    if not in_mode:
        got = corr(xi, measure=measure, **KW)
        again = corr(xi, measure=measure, **KW)
    assert xi.is_inference()
    assert api.prepared_cache_stats() == {
        "hits": 0, "misses": 0, "size": 0, "capacity": 8}
    want = corr(torch.from_numpy(a.copy()), measure=measure, **KW)
    assert torch.equal(got, want) and torch.equal(again, want)
    cache = TransformCache()
    cache.prepared(xi, measures.get(measure), None, T, LBLK, build=_zeros)
    assert len(cache) == 0 and cache.misses == 0
