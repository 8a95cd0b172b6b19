"""Port parity of merge-sort Kendall (kernels/kendall_merge.py and the
measures, plan, executor and sinks around it) against repro on the same
seeded inputs, on the CPU, where the wrapper runs its plain version (the
CUDA kernel against it: tests/test_torch_kernels_gpu.py).  The cases
mirror the reference's own tests/test_kendall_merge.py one for one, then
hold the port's tiles, plans and sinks against the reference's.

Tolerances: tau-a is an integer C - D, cast once to float32 and put through
the same EpilogueSpec, so it is bitwise the reference's (rtol = atol = 0).
tau-b multiplies C - D by per-row factors 1/sqrt(n0 - ties): jitted JAX
computes them as an rsqrt, which differs from the correctly rounded
float32 sqrt and division the port uses by up to two ulps on about a third
of the integers below 3,000,000 (an x86 CPU), so tau-b is held within 1e-6
absolute.
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import measures as ref_measures
from repro.core.api import corr as ref_corr
from repro.core.plan import ExecutionPlan as RefPlan
from repro.core.sinks import EdgeCountSink as RefEdgeCountSink
from repro.core.sinks import HostSink as RefHostSink
from repro.core.sinks import TopKSink as RefTopKSink
from repro.kernels import kendall_merge as ref_km
from repro.kernels.pcc_tile import EpilogueSpec as RefEpilogueSpec
from repro_torch import convert
from repro_torch.core import api, measures
from repro_torch.core.api import corr
from repro_torch.core.plan import ExecutionPlan, pad_operands
from repro_torch.core.significance import PermutationSpec
from repro_torch.core.sinks import (DeviceTopKSink, EdgeCountSink, HostSink,
                                    TopKSink)
from repro_torch.kernels import kendall_merge
from repro_torch.kernels.kendall_merge import (KENDALL_MERGE_CROSSOVER_L,
                                               kendall_merge_tiles,
                                               row_tie_pairs)
from repro_torch.kernels.pcc_tile import EpilogueSpec

T, LBLK = 8, 8
BIG_L = max(KENDALL_MERGE_CROSSOVER_L, 256) + 44  # above crossover, odd pad
TOL_B = 1e-6


def _x(n, l, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, l)).astype(np.float32)


def _ties(n, l, seed=1, levels=4):
    rng = np.random.default_rng(seed)
    return rng.integers(0, levels, (n, l)).astype(np.float32)


def _port(x, y=None, **kw):
    out = corr(x, y, device="cpu", **{"t": T, "l_blk": LBLK, **kw})
    return out.numpy() if isinstance(out, torch.Tensor) else out


def _ref(x, y=None, **kw):
    out = ref_corr(jnp.asarray(x), None if y is None else jnp.asarray(y),
                   **{"t": T, "l_blk": LBLK, **kw})
    return np.asarray(out) if hasattr(out, "shape") else out


# ---------------------------------------------------------------------------
# The reference's cases: exactness (merge == sign bitwise for tau-a, scipy
# for tau-b)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("data", ["float", "ties"])
def test_tau_a_merge_bitwise_equals_sign_gemm(data):
    x = _x(13, 21, seed=3) if data == "float" else _ties(13, 21, seed=4)
    sign = _port(x, measure="kendall_sign_gemm")
    merge = _port(x, measure="kendall_merge")
    np.testing.assert_array_equal(sign, merge)
    np.testing.assert_array_equal(merge, _ref(x, measure="kendall_merge"))


def test_tau_a_merge_matches_literal_oracle():
    x = _x(9, 17, seed=5)
    lit = measures.kendall_tau_a_literal(x)
    np.testing.assert_array_equal(
        lit, ref_measures.kendall_tau_a_literal(jnp.asarray(x)))
    np.testing.assert_array_equal(
        measures.kendall_tau_a_literal(torch.from_numpy(x)), lit)
    got = _port(x, measure="kendall_merge")
    assert np.abs(got - lit).max() < 1e-6
    with pytest.raises(ValueError, match="at least 2"):
        measures.kendall_tau_a_literal(x[:, :1])


@pytest.mark.parametrize("name", ["kendall_tau_b_sign_gemm",
                                  "kendall_tau_b_merge"])
def test_tau_b_tie_heavy_matches_scipy(name):
    scipy_stats = pytest.importorskip("scipy.stats")
    x = _ties(8, 30, seed=6, levels=3)  # heavy ties: ~10 samples per level
    got = _port(x, measure=name)
    for i in range(x.shape[0]):
        for j in range(i, x.shape[0]):
            ref = scipy_stats.kendalltau(x[i], x[j], variant="b").statistic
            if np.isnan(ref):
                ref = 0.0  # constant rows: the engine gives 0, scipy nan
            assert abs(got[i, j] - ref) < 1e-6, (name, i, j)


def test_merge_constant_and_padding_rows_exactly_zero():
    x = _x(6, 20, seed=7)
    x[2] = 1.5
    for name in ("kendall_merge", "kendall_tau_b_merge"):
        got = _port(x, measure=name)
        np.testing.assert_array_equal(got[2], 0.0)
        np.testing.assert_array_equal(got[:, 2], 0.0)
    # the padding rows of a launch (n = 6 -> n_pad = 8) are 0 in every tile
    u = ExecutionPlan.create(6, 20, t=T, l_blk=LBLK,
                             measure="kendall_merge").prepare(
        torch.from_numpy(x))
    tile = kendall_merge_tiles(u, 0, t=T, l_blk=LBLK, pass_tiles=1, l=20)
    np.testing.assert_array_equal(tile[0, 6:].numpy(), 0.0)
    np.testing.assert_array_equal(tile[0, :, 6:].numpy(), 0.0)


def test_row_tie_pairs_counts():
    u = torch.tensor([[1., 1., 2., 2., 2.],   # C(2,2)+C(3,2) = 1+3
                      [1., 2., 3., 4., 5.],   # no ties
                      [7., 7., 7., 7., 7.]])  # C(5,2) = 10
    got = row_tie_pairs(u)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), [4, 0, 10])
    r = _ties(11, 37, seed=2, levels=5)
    np.testing.assert_array_equal(
        row_tie_pairs(torch.from_numpy(r)).numpy(),
        np.asarray(ref_km.row_tie_pairs(jnp.asarray(r))))


def test_rectangular_grid_merge_matches_sign():
    x, y = _x(10, 19, seed=8), _x(14, 19, seed=9)
    sign = _port(x, y, measure="kendall_sign_gemm")
    merge = _port(x, y, measure="kendall_merge")
    np.testing.assert_array_equal(sign, merge)
    np.testing.assert_array_equal(merge, _ref(x, y, measure="kendall_merge"))


# ---------------------------------------------------------------------------
# The reference's cases: crossover auto-dispatch (kernel-choice spy)
# ---------------------------------------------------------------------------


def _spy(monkeypatch):
    calls = []
    real = kendall_merge_tiles

    def wrapper(u_pad, j_start, **kw):
        calls.append(kw.get("l"))
        return real(u_pad, j_start, **kw)

    monkeypatch.setattr(kendall_merge, "kendall_merge_tiles", wrapper)
    return calls


def test_dispatch_above_crossover_uses_merge(monkeypatch):
    calls = _spy(monkeypatch)
    x = _x(10, BIG_L, seed=10)
    plan = ExecutionPlan.create(10, BIG_L, t=T, l_blk=LBLK, measure="kendall")
    assert plan.measure is measures.KENDALL_MERGE
    assert plan.spec_dict()["tile_kernel"] == "kendall_merge_tile_kernel"
    got = _port(x, measure="kendall")
    assert calls and all(c == BIG_L for c in calls)
    np.testing.assert_array_equal(got, _ref(x, measure="kendall"))


def test_dispatch_below_crossover_uses_sign_gemm(monkeypatch):
    calls = _spy(monkeypatch)
    l = KENDALL_MERGE_CROSSOVER_L - 1
    plan = ExecutionPlan.create(10, l, t=T, l_blk=LBLK, measure="kendall")
    assert plan.measure is measures.KENDALL
    assert plan.spec_dict()["tile_kernel"] is None
    _port(_x(10, l, seed=11), measure="kendall")
    assert calls == []


def test_forced_variants_escape_dispatch(monkeypatch):
    calls = _spy(monkeypatch)
    # sign forced above the crossover
    plan = ExecutionPlan.create(8, BIG_L, t=T, l_blk=LBLK,
                                measure="kendall_sign_gemm")
    assert plan.measure.tile_kernel is None
    _port(_x(8, BIG_L, seed=12), measure="kendall_sign_gemm")
    assert calls == []
    # merge forced below the crossover
    plan = ExecutionPlan.create(8, 16, t=T, l_blk=LBLK,
                                measure="kendall_merge")
    assert plan.measure is measures.KENDALL_MERGE
    _port(_x(8, 16, seed=13), measure="kendall_merge")
    assert calls and all(c == 16 for c in calls)


@pytest.mark.parametrize("meas,kw", [
    ("KENDALL", dict(l=BIG_L, compute_dtype="int8")),
    ("KENDALL", dict(l=BIG_L, replicas=8)),
    ("KENDALL_B", dict(l=BIG_L)),
    ("KENDALL", dict(l=BIG_L)),
    ("KENDALL", dict(l=KENDALL_MERGE_CROSSOVER_L - 1)),
    ("KENDALL_SIGN", dict(l=BIG_L)),
    ("KENDALL_B_SIGN", dict(l=BIG_L)),
    ("KENDALL_MERGE", dict(l=16)),
    ("PEARSON", dict(l=BIG_L)),
])
def test_dispatch_stays_sign_for_int8_and_replicas(meas, kw):
    """resolve_tile_kernel picks the same variant as the reference's, by
    name, for every (measure, l, compute_dtype, replicas) here."""
    kw = dict(kw)
    cd = kw.pop("compute_dtype", None)
    got = measures.resolve_tile_kernel(
        getattr(measures, meas), compute_dtype=None if cd is None
        else torch.int8, **kw)
    want = ref_measures.resolve_tile_kernel(
        getattr(ref_measures, meas), compute_dtype=None if cd is None
        else jnp.dtype(jnp.int8), **kw)
    assert got.name == want.name
    assert got is measures.get(want.name)


def test_tau_b_dispatches_too():
    plan = ExecutionPlan.create(8, BIG_L, t=T, l_blk=LBLK,
                                measure="kendall_tau_b")
    assert plan.measure is measures.KENDALL_B_MERGE
    assert plan.spec_dict()["tile_kernel"] == \
        "kendall_tau_b_merge_tile_kernel"


# ---------------------------------------------------------------------------
# The reference's cases: the operand is O(l), loud failures
# ---------------------------------------------------------------------------


def test_merge_path_operand_is_linear_in_l(monkeypatch):
    """Above the crossover the prepared Kendall operand is the (n_pad,
    l_pad) float32 rank matrix, and that is what the tile kernel gets: the
    C(l, 2) pair expansion never materializes."""
    n, l = 10, BIG_L
    shapes = []
    real = kendall_merge_tiles

    def wrapper(u_pad, j_start, **kw):
        shapes.append((tuple(u_pad.shape), u_pad.dtype))
        return real(u_pad, j_start, **kw)

    monkeypatch.setattr(kendall_merge, "kendall_merge_tiles", wrapper)
    plan = ExecutionPlan.create(n, l, t=T, l_blk=LBLK, measure="kendall")
    u = plan.prepare(torch.from_numpy(_x(n, l, seed=14)))
    l_pad = -(-l // LBLK) * LBLK
    assert tuple(u.shape) == (16, l_pad) == (plan.n_pad, plan.l_pad)
    _port(_x(n, l, seed=14), measure="kendall")
    assert shapes and set(shapes) == {((16, l_pad), torch.float32)}


def test_sign_path_operand_is_quadratic_in_l():
    n, l = 6, 40
    u = ExecutionPlan.create(n, l, t=T, l_blk=LBLK,
                             measure="kendall_sign_gemm").prepare(
        torch.from_numpy(_x(n, l, seed=15)))
    assert u.shape[1] >= l * (l - 1) // 2


def test_merge_with_compute_dtype_raises():
    with pytest.raises(ValueError, match="kendall_sign_gemm"):
        ExecutionPlan.create(8, BIG_L, t=T, l_blk=LBLK,
                             measure="kendall_merge",
                             compute_dtype=torch.int8)


def test_merge_with_replicas_raises():
    with pytest.raises(ValueError, match="replica"):
        ExecutionPlan.create(8, BIG_L, t=T, l_blk=LBLK,
                             measure="kendall_merge", replicas=4)


def test_merge_dense_reference_delegates_to_sign_twin():
    x = torch.from_numpy(_x(6, 14))
    for merge, sign in (("kendall_merge", "kendall"),
                        ("kendall_tau_b_merge", "kendall_tau_b")):
        got = measures.dense_reference(x, measure=merge)
        assert torch.equal(got, measures.dense_reference(x, measure=sign))
        np.testing.assert_allclose(
            got.numpy(), np.asarray(ref_measures.dense_reference(
                jnp.asarray(x.numpy()), measure=merge)), rtol=0, atol=TOL_B)
        assert torch.equal(measures.dense_reference_pair(x, x[:4], merge),
                           measures.dense_reference_pair(x, x[:4], sign))
    # a user's custom-kernel measure with no twin still raises
    custom = dataclasses.replace(measures.KENDALL_MERGE, name="custom_merge")
    with pytest.raises(ValueError, match="inner product"):
        measures.dense_reference(x, measure=custom)


def test_merge_kernel_input_validation():
    u = torch.zeros((8, 8))
    with pytest.raises(ValueError, match="at least 2"):
        kendall_merge_tiles(u, 0, t=8, l_blk=8, pass_tiles=1, l=1)
    with pytest.raises(ValueError, match="replica"):
        kendall_merge_tiles(u, 0, t=8, l_blk=8, pass_tiles=1, l=8,
                            v_pad=torch.zeros((2, 8, 8)))
    with pytest.raises(ValueError, match="not aligned"):
        kendall_merge_tiles(u, 0, t=8, l_blk=8, pass_tiles=1, l=9)
    with pytest.raises(ValueError, match="pass_tiles"):
        kendall_merge_tiles(u, 0, t=8, l_blk=8, pass_tiles=0, l=8)
    with pytest.raises(ValueError, match="matches u_pad"):
        kendall_merge_tiles(u, 0, t=8, l_blk=8, pass_tiles=1, l=8,
                            v_pad=torch.zeros((16, 8)))
    with pytest.raises(ValueError, match="grid_cols"):
        kendall_merge_tiles(u, 0, t=8, l_blk=8, pass_tiles=1, l=8,
                            v_pad=torch.zeros((16, 8)), grid_cols=3)


def test_significance_with_kendall_uses_sign_path_end_to_end():
    """corr(pvalues=) on large-l Kendall routes to the sign path (the merge
    kernel has no replica mode) and still answers; r is the merge path's."""
    x = _x(6, 100, seed=16)
    r, p = corr(x, measure="kendall", t=T, l_blk=512, device="cpu",
                pvalues=PermutationSpec(iterations=6, key=1))
    np.testing.assert_array_equal(
        r.numpy(), _port(x, measure="kendall", l_blk=512))
    assert float(p.min()) >= 1.0 / 7.0 - 1e-7


# ---------------------------------------------------------------------------
# The port's tiles against the reference's, on the same padded ranks
# ---------------------------------------------------------------------------

# (n, n_cols or None, l, j_start, pass_tiles): n never a multiple of t
# (padding rows), a constant row and a near-constant one in each operand;
# the last case's ids run past the end (the tail clamp)
TILE_CASES = [(19, None, 21, 0, 6), (19, 13, 30, 1, 5), (21, None, 97, 3, 5)]


def _ranks(x):
    return pad_operands(measures.kendall_rank_transform(torch.from_numpy(x)),
                        T, LBLK)


@pytest.mark.parametrize("tau_b", [False, True])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("case", TILE_CASES)
def test_tiles_equal_reference(case, fused, tau_b):
    n, n_cols, l, j0, tiles = case
    x = _ties(n, l, seed=n + l, levels=3 + l // 10)
    x[2] = 2.0
    x[5, : l - 1] = 1.0
    u = _ranks(x)
    v = gc = None
    if n_cols is not None:
        y = _x(n_cols, l, seed=l)
        y[0] = 0.0
        v = _ranks(y)
        gc = v.shape[0] // T
    div = None if tau_b else float(l * (l - 1) // 2)
    spec = EpilogueSpec(div=div, clip=(-1.0, 1.0)) if fused else None
    ref_spec = RefEpilogueSpec(div=div, clip=(-1.0, 1.0)) if fused else None
    got = kendall_merge_tiles(u, j0, t=T, l_blk=LBLK, pass_tiles=tiles,
                              epilogue=spec, v_pad=v, grid_cols=gc, l=l,
                              tau_b=tau_b)
    want = np.asarray(ref_km.kendall_merge_tiles(
        jnp.asarray(u.numpy()), j0, t=T, l_blk=LBLK, pass_tiles=tiles,
        epilogue=ref_spec, v_pad=None if v is None else jnp.asarray(v.numpy()),
        grid_cols=gc, l=l, tau_b=tau_b))
    assert got.shape == want.shape == (tiles, T, T)
    if tau_b:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL_B)
    else:
        np.testing.assert_array_equal(got.numpy(), want)
    if fused:  # the fused epilogue is the unfused one applied after
        raw = kendall_merge_tiles(u, j0, t=T, l_blk=LBLK, pass_tiles=tiles,
                                  v_pad=v, grid_cols=gc, l=l, tau_b=tau_b)
        assert torch.equal(got, spec.apply(raw))
    assert kendall_merge_tiles.launches == 0  # the CPU runs the plain one


@pytest.mark.parametrize("l", [96, 130])
@pytest.mark.parametrize("measure", ["kendall", "kendall_tau_b"])
def test_corr_end_to_end_equals_reference(l, measure):
    x = _ties(21, l, seed=l, levels=12)
    x[:, ::3] = _x(21, l, seed=1)[:, ::3]
    x[4] = 0.5
    y = _x(11, l, seed=l + 1)
    for yy in (None, y):
        got, want = _port(x, yy, measure=measure), _ref(x, yy, measure=measure)
        if measure == "kendall":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=TOL_B)
    sym = _port(x, measure=measure)
    np.testing.assert_array_equal(sym, sym.T)
    # unfused, or in 4-tile passes: the same bits
    for kw in (dict(fuse_epilogue=False), dict(max_tiles_per_pass=4)):
        np.testing.assert_array_equal(sym, _port(x, measure=measure, **kw))


# ---------------------------------------------------------------------------
# Plans, checkpoints and sinks over merge tiles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("measure,n_cols,mtp", [
    ("kendall", None, None), ("kendall_tau_b", 21, 4),
    ("kendall_merge", None, 3), ("kendall_tau_b_merge", 21, None)])
def test_spec_dict_equals_reference_and_converts(measure, n_cols, mtp):
    kw = dict(n_cols=n_cols, t=T, l_blk=LBLK, measure=measure,
              max_tiles_per_pass=mtp)
    got = ExecutionPlan.create(37, 120, **kw).spec_dict()
    want = RefPlan.create(37, 120, **kw).spec_dict()
    assert got == want and list(got) == list(want)
    assert got["tile_kernel"].endswith("merge_tile_kernel")
    back = convert.plan_from_reference(want)
    assert back.measure is ExecutionPlan.create(37, 120, **kw).measure
    assert back.spec_dict() == want


class _RefStopAfter(RefHostSink):
    """The reference's HostSink, stopped once pass `k` is committed."""

    def __init__(self, path, k):
        super().__init__(path=path)
        self._stop = k

    def pass_complete(self, k):
        super().pass_complete(k)
        if k == self._stop:
            raise RuntimeError(f"stopped after pass {k}")


class _StopAfter(HostSink):
    """The port's HostSink, stopped the same way."""

    def __init__(self, path, k):
        super().__init__(path=path)
        self._stop = k

    def pass_complete(self, k):
        super().pass_complete(k)
        if k == self._stop:
            raise RuntimeError(f"stopped after pass {k}")


def test_host_sink_merge_checkpoint_resumes_across_packages(tmp_path,
                                                           monkeypatch):
    """A merge-sort Kendall checkpoint either package left half done
    resumes in the other, launching only the missing passes: the same
    spec (tile kernel by name), the same bits."""
    x = _x(29, 100, seed=17)
    kw = dict(measure="kendall", max_tiles_per_pass=4)   # 10 tiles, 3 passes
    full = _port(x, **kw)
    np.testing.assert_array_equal(full, _ref(x, **kw))
    path = str(tmp_path / "ref.mm")
    with pytest.raises(RuntimeError, match="stopped"):
        _ref(x, sink=_RefStopAfter(path, 0), **kw)
    calls = _spy(monkeypatch)
    np.testing.assert_array_equal(_port(x, resume_from=path, **kw), full)
    assert len(calls) == 2
    path = str(tmp_path / "port.mm")
    with pytest.raises(RuntimeError, match="stopped"):
        _port(x, sink=_StopAfter(path, 1), **kw)
    np.testing.assert_array_equal(_ref(x, resume_from=path, **kw), full)


def test_topk_and_edge_count_sinks_take_merge_tiles():
    x = _x(27, 100, seed=18)
    kw = dict(measure="kendall", max_tiles_per_pass=3)
    got = _port(x, sink=TopKSink(4), **kw)
    want = _ref(x, sink=RefTopKSink(4), **kw)
    np.testing.assert_array_equal(got["indices"], np.asarray(want["indices"]))
    np.testing.assert_array_equal(got["values"], np.asarray(want["values"]))
    labels = np.arange(27) % 3
    got = _port(x, sink=EdgeCountSink(0.12, labels=labels), **kw)
    want = _ref(x, sink=RefEdgeCountSink(0.12, labels=labels), **kw)
    assert got["edges"] == want["edges"] > 0
    np.testing.assert_array_equal(got["degrees"], want["degrees"])
    assert got["intra_edges"] == want["intra_edges"]


def test_device_topk_sink_refuses_merge_tiles():
    plan = ExecutionPlan.create(20, 100, t=T, l_blk=LBLK, measure="kendall")
    assert not DeviceTopKSink.supports(plan)
    with pytest.raises(ValueError, match="custom tile kernels"):
        _port(_x(20, 100, seed=19), measure="kendall",
              sink=DeviceTopKSink(3))


def test_cache_keeps_merge_ranks_and_int8_signs_apart():
    """One tensor asked for kendall at l = 100 with no compute_dtype (ranks,
    the merge kernel) and with int8 (pair signs): two entries, each hit on
    its repeat, each result the uncached one's."""
    x = torch.from_numpy(_x(12, 100, seed=20))
    cache = api.TransformCache()
    merge = ExecutionPlan.create(12, 100, t=T, l_blk=LBLK, measure="kendall")
    signs = ExecutionPlan.create(12, 100, t=T, l_blk=LBLK, measure="kendall",
                                 compute_dtype="int8")
    a = api.prepared_operand(merge, x, cache=cache)
    b = api.prepared_operand(signs, x, cache=cache)
    assert cache.stats()["misses"] == 2 and len(cache) == 2
    assert a.dtype == torch.float32 and tuple(a.shape) == (16, 104)
    assert b.dtype == torch.int8 and b.shape[1] >= 100 * 99 // 2
    assert api.prepared_operand(merge, x, cache=cache) is a
    assert api.prepared_operand(signs, x, cache=cache) is b
    assert cache.stats()["hits"] == 2
    api.clear_prepared_cache()
    first = _port(x, measure="kendall")
    int8 = _port(x, measure="kendall", compute_dtype="int8")
    np.testing.assert_array_equal(first, int8)   # tau-a bitwise either way
    np.testing.assert_array_equal(_port(x, measure="kendall"), first)
    assert api.prepared_cache_stats()["hits"] == 1
    api.clear_prepared_cache()


def test_tau_b_scale_is_correctly_rounded():
    """Every tie count at l = 2,449 (n0 ~ 3e6): the float32 sqrt of
    n0 - ties correctly rounded, then its reciprocal correctly rounded
    (float64 then float32 is exact rounding for both), and 0 for a
    constant row; the same bits whatever device the ties are on."""
    l = 2449
    n0 = l * (l - 1) // 2
    ties = torch.arange(0, n0 + 1, dtype=torch.int32)
    got = kendall_merge.tau_b_scale(ties, l).numpy()
    nz = (n0 - np.arange(0, n0, dtype=np.float64))
    root = np.sqrt(nz).astype(np.float32).astype(np.float64)
    np.testing.assert_array_equal(got[:-1], (1.0 / root).astype(np.float32))
    assert got[-1] == 0.0 and got.dtype == np.float32


def test_rank_structure_made_once_per_operand(monkeypatch):
    """The passes of a run share one rank structure per operand; an
    in-place write makes a new one, and the entry goes with its operand."""
    made = []
    real = kendall_merge.rank_structure

    def counted(u_l):
        made.append(tuple(u_l.shape))
        return real(u_l)

    monkeypatch.setattr(kendall_merge, "rank_structure", counted)
    l = 100
    u = pad_operands(measures.kendall_rank_transform(
        torch.from_numpy(_ties(20, l, seed=21))), T, LBLK)
    v = pad_operands(measures.kendall_rank_transform(
        torch.from_numpy(_x(12, l, seed=22))), T, LBLK)
    kw = dict(t=T, l_blk=LBLK, pass_tiles=2, l=l, tau_b=True)
    first = [kendall_merge_tiles(u, j, **kw) for j in range(0, 6, 2)]
    assert made == [(24, l)]
    grid = kendall_merge_tiles(u, 0, v_pad=v, grid_cols=2, **kw)
    assert made == [(24, l), (16, l)]
    u.add_(0.0)
    again = kendall_merge_tiles(u, 0, **kw)
    assert len(made) == 3
    assert torch.equal(again, first[0])
    n_entries = len(kendall_merge._STRUCTURES)
    del u
    assert len(kendall_merge._STRUCTURES) == n_entries - 1
    assert torch.equal(grid, kendall_merge.kendall_merge_tiles_plain(
        pad_operands(measures.kendall_rank_transform(
            torch.from_numpy(_ties(20, l, seed=21))), T, LBLK), 0,
        v_pad=v, grid_cols=2, **kw))
    assert len(made) == 4


# ---------------------------------------------------------------------------
# What the redesigned kernel computes (csrc/kendall_merge.cu), in plain
# torch on the CPU: one sort a pair, the launch geometry, the rank
# structure's new fields and the sort's count itself
# ---------------------------------------------------------------------------


def _tied_rows(kind, n, l, seed):
    """Seeded rows with ties: integer levels (few long runs), a few tied
    pairs among normals (runs of 2), or a mix of one long run and
    singletons."""
    rng = np.random.default_rng(seed)
    if kind == "levels":
        return rng.integers(0, rng.integers(2, 9), (n, l)).astype(np.float32)
    x = rng.standard_normal((n, l)).astype(np.float32)
    if kind == "pairs":
        for row in x:
            a = rng.choice(l, 2 * max(1, l // 20), replace=False)
            row[a[1::2]] = row[a[::2]]
    else:  # "long": one run of a random length, the rest distinct
        for row in x:
            row[rng.choice(l, rng.integers(2, l + 1), replace=False)] = 3.5
    return x


def _one_sort_terms(x, y):
    """Knight's (n3, S) of rows x and y written out as the kernel's one-sort
    path counts them: q = y's dense codes in x's stable order, S = inv(q) -
    I_w with I_w the strict inversions of q inside x's tie runs, n3 the
    pairs of equal q inside them; every count by direct compares."""
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    order = torch.sort(xt, stable=True).indices
    runs = torch.unique_consecutive(xt[order], return_inverse=True)[1]
    q = torch.unique(yt, return_inverse=True)[1][order]
    later = torch.triu(torch.ones(len(q), len(q), dtype=torch.bool), 1)
    greater = later & (q[:, None] > q[None, :])
    same_run = runs[:, None] == runs[None, :]
    inv = int(greater.sum())
    i_w = int((greater & same_run).sum())
    n3 = int((later & same_run & (q[:, None] == q[None, :])).sum())
    return n3, inv - i_w


def _two_sort_terms(x, y):
    """The same as the kernel's long-run path counts them: sort the keys
    (run, q) (the lexsort; n3 from runs of equal keys), then S = the strict
    inversions of q in that order."""
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    order = torch.sort(xt, stable=True).indices
    runs = torch.unique_consecutive(xt[order], return_inverse=True)[1]
    q = torch.unique(yt, return_inverse=True)[1][order]
    key = torch.sort(runs * len(q) + q).values
    n3 = int(kendall_merge._run_pair_count(kendall_merge._new_runs(key)))
    qs = key % len(q)
    later = torch.triu(torch.ones(len(q), len(q), dtype=torch.bool), 1)
    return n3, int((later & (qs[:, None] > qs[None, :])).sum())


@pytest.mark.parametrize("path", ["one_sort", "two_sorts"])
@pytest.mark.parametrize("kind", ["levels", "pairs", "long"])
def test_kernel_pair_terms_match_reference(path, kind):
    """S = inv(q) - I_w and n3 by runs (one sort), and the lexsort's two
    sorts, both equal the reference's _pair_terms on every pair of seeded
    tied rows (tied columns too)."""
    terms = _one_sort_terms if path == "one_sort" else _two_sort_terms
    for l in (2, 7, 40, 97):
        x = _tied_rows(kind, 5, l, seed=l)
        y = _tied_rows("levels" if kind == "long" else kind, 5, l,
                       seed=l + 1)
        for i in range(5):
            for j in range(5):
                n3, s = ref_km._pair_terms(jnp.asarray(x[i]),
                                           jnp.asarray(y[j]), l)
                assert terms(x[i], y[j]) == (int(n3), int(s))


def test_kernel_constants_match_the_cuda_source():
    """The wrapper's SHORT_RUN_MAX (which rows take uint32 keys) and
    MAX_KERNEL_L (where it raises) are the kernel's own."""
    src = (Path(kendall_merge.__file__).parent / "csrc" /
           "kendall_merge.cu").read_text()
    assert (f"constexpr int SHORT_RUN_MAX = {kendall_merge.SHORT_RUN_MAX};"
            in src)
    assert f"constexpr int MAX_L = {kendall_merge.MAX_KERNEL_L};" in src


def _direct_structure(x):
    """order, runs and codes of the rows x (n, l), int32, each row by
    numpy: its stable argsort, the run index of each sorted position and
    each value's dense rank."""
    order = np.argsort(x, axis=1, kind="stable")
    runs = np.stack([np.unique(row, return_inverse=True)[1][o]
                     for row, o in zip(x, order)])
    codes = np.stack([np.unique(row, return_inverse=True)[1] for row in x])
    return [torch.from_numpy(a.astype(np.int32)) for a in (order, runs,
                                                          codes)]


@pytest.mark.parametrize("l", [2, 45, 100, 130])
def test_rank_structure_longest_runs_and_int16_rows(l):
    """``longest`` is each row's longest run of equal values by a direct
    count, ``wide`` whether a non-constant row's exceeds SHORT_RUN_MAX, and
    order / runs / codes are kept once, as int16 rows padded with zeros to
    a stride that is a multiple of 8, equal to a direct count."""
    r = kendall_merge.SHORT_RUN_MAX
    x = _tied_rows("pairs", 6, l, seed=l)
    x[0] = 1.0                                   # constant: never wide
    if l > r + 1:
        x[1, :r] = 9.0                           # exactly SHORT_RUN_MAX
    st = kendall_merge.rank_structure(torch.from_numpy(x))
    want = []
    for row in np.sort(x, axis=1):
        bounds = np.flatnonzero(np.diff(row) != 0)
        want.append(int(np.diff(np.r_[-1, bounds, l - 1]).max()))
    assert st.longest.tolist() == want and st.longest.dtype == torch.int32
    assert not st.wide
    ld = kendall_merge.narrow_stride(l)
    assert ld % 8 == 0 and l <= ld < l + 8
    for got, direct in zip((st.order, st.runs, st.codes),
                           _direct_structure(x)):
        assert got.dtype == torch.int16 and got.shape == (6, ld)
        assert torch.equal(got[:, :l].int(), direct)
        assert not got[:, l:].any()
    if l > r + 1:
        x[2, :r + 1] = 9.0                       # one longer: two sorts
        assert kendall_merge.rank_structure(torch.from_numpy(x)).wide


def test_rank_structure_has_no_int16_rows_past_the_kernel():
    """Past MAX_KERNEL_L the one copy is int32 (n, l), a direct count."""
    l = kendall_merge.MAX_KERNEL_L + 1
    x = np.stack([np.random.default_rng(5).permutation(l),
                  np.arange(l) // 3]).astype(np.float32)
    st = kendall_merge.rank_structure(torch.from_numpy(x))
    for got, direct in zip((st.order, st.runs, st.codes),
                           _direct_structure(x)):
        assert got.dtype == torch.int32 and torch.equal(got, direct)
    assert st.longest.tolist() == [1, 3]


@pytest.mark.parametrize("l", [7, 130])
def test_plain_pair_terms_read_either_row_layout(l):
    """The plain version's Knight's terms are the same whether the rank
    structure keeps int16 rows of the kernel's stride (l <= MAX_KERNEL_L)
    or int32 rows of l (above it)."""
    x = _tied_rows("levels", 6, l, seed=3 * l)
    st = kendall_merge.rank_structure(torch.from_numpy(x))
    wide = dataclasses.replace(
        st, **{f: getattr(st, f)[:, :l].int().contiguous()
               for f in ("order", "runs", "codes")})
    ri, ci = torch.arange(6), torch.arange(6)
    for a, b in zip(kendall_merge._pair_terms(st, st, ri, ci, l),
                    kendall_merge._pair_terms(wide, wide, ri, ci, l)):
        assert torch.equal(a, b)


def _kernel_sort_count(keys, p, e, sentinel):
    """The kernel's count of one group, thread by thread: P threads of E
    keys (the P E - l tail sentinels); each sorts its E keys by odd-even
    transposition counting swaps, then log2(P) merge-path levels, each
    thread's co-rank by binary search and E outputs merged ties-left,
    adding the left keys still waiting for each right key taken."""
    a = list(keys) + [sentinel] * (p * e - len(keys))
    inv = 0
    for g in range(p):
        v = a[g * e:(g + 1) * e]
        for r in range(e):
            for x in range(r & 1, e - 1, 2):
                if v[x] > v[x + 1]:
                    v[x], v[x + 1] = v[x + 1], v[x]
                    inv += 1
        a[g * e:(g + 1) * e] = v
    for k in range(p.bit_length() - 1):
        blk, out = e << k, [None] * (p * e)
        for g in range(p):
            base = (g >> (k + 1) << (k + 1)) * e
            d = (g & ((2 << k) - 1)) * e
            left, right = a[base:base + blk], a[base + blk:base + 2 * blk]
            lo, hi = max(0, d - blk), min(d, blk)
            while lo < hi:
                mid = (lo + hi) // 2
                if left[mid] <= right[d - mid - 1]:
                    lo = mid + 1
                else:
                    hi = mid
            i, j = lo, d - lo
            for s in range(e):
                if j >= blk or (i < blk and left[i] <= right[j]):
                    out[base + d + s] = left[i]
                    i += 1
                else:
                    out[base + d + s] = right[j]
                    inv += blk - i
                    j += 1
        a = out
    assert a[:len(keys)] == sorted(keys)
    return inv


@pytest.mark.parametrize("p,e", [(32, 2), (32, 3), (32, 12), (256, 6)])
def test_kernel_sort_count_is_the_strict_inversion_count(p, e):
    """Leaf swaps plus merge levels count exactly the strict inversions of
    keys with ties, at every length up to P E and at its edges: the
    sentinel tail never counts."""
    rng = np.random.default_rng(p * e)
    lengths = {1, 2, e, e + 1, p * e // 2 + 1, p * e - 1, p * e}
    for l in sorted(lengths):
        for levels in (3, l + 1):
            keys = rng.integers(0, levels, l)
            want = int(np.triu(keys[:, None] > keys[None, :], 1).sum())
            assert _kernel_sort_count(keys.tolist(), p, e, 0xFFFF) == want
