"""Port parity of the masked (pairwise-complete) path: corr(x, where=),
corr(x, y, where=), the masked measures' pieces and the tile kernel's
triangle with a second operand, against ``repro`` on the CPU.

Tolerances:
- against the reference, 3e-6: both packages sum the same float32 products
  of each component in different orders, and the combine cancels
  (n * sxy - sx * sy).  At these shapes (l <= 40, values O(1)) a component
  is at most ~40 * 10, one float32 ulp ~4e-6 of it, and the combine divides
  by a denominator of the same size, so the result moves by ~1e-7;
- fully observed masked against unmasked corr, 2e-4: the reference's own
  bound for the two decompositions (tests/test_api.py);
- masked operands, the boolean-mask / NaN-mask agreement, the clip and the
  symmetry: bitwise.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import measures as ref_measures
from repro.core.api import corr as ref_corr
from repro.core.sinks import DenseSink as RefDenseSink
from repro.core.sinks import TopKSink as RefTopKSink
from repro.kernels.pcc_tile import pcc_tiles as ref_pcc_tiles
from repro_torch import convert
from repro_torch.core import allpairs, measures
from repro_torch.core.api import PairwiseProblem, corr
from repro_torch.core.plan import ExecutionPlan, pad_operands
from repro_torch.core.sinks import DeviceTopKSink, TopKSink
from repro_torch.kernels.pcc_tile import pcc_tiles, pcc_tiles_plain

ATOL = 3e-6
MEASURES = ["pearson", "cosine", "covariance"]
# (n, n_cols, l, t, l_blk, max_tiles_per_pass): n never a multiple of t,
# several passes with a ragged last one
CASES = [(17, 11, 24, 8, 8, 2), (37, 21, 29, 8, 8, 4),
         (45, 30, 40, 16, 8, 2)]


def _nan_x(n, l, seed=0, frac=0.3):
    """Normal data with a share `frac` missing (NaN), completely at random;
    the first two samples of every row stay observed, as in the
    reference's tests, plus a constant row (zero variance on any
    support)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, l)).astype(np.float32)
    x[rng.random((n, l)) < frac] = np.nan
    x[:, :2] = rng.standard_normal((n, 2)).astype(np.float32)
    x[n // 2] = np.where(np.isnan(x[n // 2]), np.nan, 0.75)
    return x


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("n,n_cols,l,t,l_blk,mtp", CASES)
def test_symmetric_masked_corr_matches_reference(measure, n, n_cols, l, t,
                                                 l_blk, mtp):
    x = _nan_x(n, l, seed=n)
    kw = dict(measure=measure, t=t, l_blk=l_blk, max_tiles_per_pass=mtp)
    got = corr(x, where="nan", device="cpu", **kw)
    want = np.asarray(ref_corr(jnp.asarray(x), where="nan", **kw))
    assert got.shape == (n, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    # exactly symmetric, as the reference's
    assert torch.equal(got, got.T)
    np.testing.assert_array_equal(want, want.T)
    # the pass split does not change a bit
    assert torch.equal(got, corr(x, where="nan", device="cpu",
                                 **{**kw, "max_tiles_per_pass": None}))


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("n,n_cols,l,t,l_blk,mtp", CASES)
def test_rectangular_masked_corr_matches_reference(measure, n, n_cols, l, t,
                                                   l_blk, mtp):
    x, y = _nan_x(n, l, seed=n), _nan_x(n_cols, l, seed=n_cols + 100)
    kw = dict(measure=measure, t=t, l_blk=l_blk, max_tiles_per_pass=mtp)
    got = corr(x, y, where="nan", device="cpu", **kw)
    want = np.asarray(ref_corr(jnp.asarray(x), jnp.asarray(y), where="nan",
                               **kw))
    assert got.shape == (n, n_cols)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    # a tuple of masks: explicit booleans and None (from NaNs) agree
    mask_y = ~np.isnan(y)
    for where in ((None, None), (~np.isnan(x), mask_y),
                  (None, torch.from_numpy(mask_y))):
        assert torch.equal(corr(x, y, where=where, device="cpu", **kw), got)


def test_bool_mask_equals_nan_mask_bitwise():
    rng = np.random.default_rng(14)
    x = rng.standard_normal((20, 18)).astype(np.float32)
    mask = rng.random((20, 18)) > 0.3
    mask[:, :2] = True
    x_nan = np.where(mask, x, np.nan).astype(np.float32)
    kw = dict(t=8, l_blk=8, max_tiles_per_pass=3, device="cpu")
    via_nan = corr(x_nan, where="nan", **kw)
    assert torch.equal(corr(x, where=mask, **kw), via_nan)
    assert torch.equal(corr(torch.from_numpy(x),
                            where=torch.from_numpy(mask), **kw), via_nan)
    want = ref_corr(jnp.asarray(x), where=jnp.asarray(mask), t=8, l_blk=8)
    np.testing.assert_allclose(via_nan.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("measure", MEASURES)
def test_fully_observed_masked_matches_unmasked(measure):
    rng = np.random.default_rng(15)
    x = rng.standard_normal((25, 40)).astype(np.float32)
    kw = dict(measure=measure, t=8, l_blk=8)
    masked = corr(x, where=np.ones(x.shape, bool), device="cpu", **kw)
    plain = corr(x, device="cpu", **kw)
    np.testing.assert_allclose(masked.numpy(), plain.numpy(), rtol=0,
                               atol=2e-4)
    want = ref_corr(jnp.asarray(x), where=jnp.ones(x.shape, bool), **kw)
    np.testing.assert_allclose(masked.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_masked_rejections_match_the_reference():
    xm = _nan_x(10, 12, seed=16)
    y = _nan_x(5, 12, seed=17)
    cases = [
        (dict(where="nan", measure="spearman"), "no pairwise-complete"),
        (dict(where="nan", measure="kendall"), "no pairwise-complete"),
        (dict(where="nan", compute_dtype=torch.bfloat16), "compute_dtype"),
        (dict(where="nan", compute_dtype="int8"), "compute_dtype"),
        (dict(where="nans"), "not understood"),
        (dict(where=np.ones((3, 3), bool)), "shape"),
        (dict(where=(None, np.ones(xm.shape, bool))), "single mask"),
    ]
    for kw, match in cases:
        with pytest.raises(ValueError, match=match):
            corr(xm, t=8, l_blk=8, device="cpu", **kw)
        ref_kw = {k: (str(v).removeprefix("torch.")
                      if k == "compute_dtype" else v) for k, v in kw.items()}
        with pytest.raises(ValueError, match=match):
            ref_corr(jnp.asarray(xm), t=8, l_blk=8, **ref_kw)
    for where, match in [(np.ones(xm.shape, bool), "both"),
                         ((None, np.ones((3, 3), bool)), "shape")]:
        with pytest.raises(ValueError, match=match):
            corr(xm, y, where=where, t=8, l_blk=8, device="cpu")
        with pytest.raises(ValueError, match=match):
            ref_corr(jnp.asarray(xm), jnp.asarray(y), where=where, t=8,
                     l_blk=8)


def test_pairwise_problem_resolution():
    x = _nan_x(6, 8, seed=18)
    p = PairwiseProblem.create(x, device="cpu")
    assert p.symmetric and not p.masked and p.mask_x is None
    p2 = PairwiseProblem.create(x, where="nan", device="cpu")
    assert p2.masked and p2.mask_y is None
    assert torch.equal(p2.mask_x, torch.from_numpy(~np.isnan(x)))
    p3 = PairwiseProblem.create(x, _nan_x(4, 8, seed=19), where=(None, None),
                                device="cpu")
    assert p3.masked and not p3.symmetric and p3.mask_y.shape == (4, 8)
    assert p3.mask_x.dtype == torch.bool


def test_clip_flag_and_sink_plan_identity():
    xm = _nan_x(14, 16, seed=42)
    kw = dict(t=8, l_blk=8, device="cpu")
    unclipped = corr(xm, where="nan", clip=False, **kw)
    clipped = corr(xm, where="nan", clip=True, **kw)
    assert torch.equal(torch.clamp(unclipped, -1.0, 1.0), clipped)

    class Recording(RefDenseSink):
        def open(self, plan):
            super().open(plan)
            specs.append(plan.spec_dict())

    for clip in (True, False):
        for y in (None, _nan_x(9, 16, seed=43)):
            specs = []
            ref_corr(jnp.asarray(xm), None if y is None else jnp.asarray(y),
                     where="nan", t=8, l_blk=8, max_tiles_per_pass=3,
                     clip=clip, sink=Recording())
            plan = convert.plan_from_reference(specs[0])
            assert plan.spec_dict() == specs[0]
            assert plan.measure.name == "pearson_complete" and not plan.fused


def test_masked_topk_excludes_self_pairs_and_matches_reference():
    xm = _nan_x(30, 25, seed=40)
    kw = dict(t=8, l_blk=8, max_tiles_per_pass=3)
    top = corr(xm, where="nan", sink=TopKSink(4), device="cpu", **kw)
    assert not np.any(top["indices"] == np.arange(30)[:, None])
    want = ref_corr(jnp.asarray(xm), where="nan", sink=RefTopKSink(4), **kw)
    np.testing.assert_array_equal(top["indices"], want["indices"])
    np.testing.assert_allclose(top["values"], want["values"], rtol=0,
                               atol=ATOL)
    # the port's own dense result ranks the same way
    dense = corr(xm, where="nan", device="cpu", **kw).numpy()
    np.fill_diagonal(dense, 0.0)
    for i in range(30):
        assert set(top["indices"][i]) == set(
            np.argsort(-np.abs(dense[i]), kind="stable")[:4])
    ym = _nan_x(13, 25, seed=41)
    rtop = corr(xm, ym, where="nan", sink=TopKSink(3), device="cpu", **kw)
    rwant = ref_corr(jnp.asarray(xm), jnp.asarray(ym), where="nan",
                     sink=RefTopKSink(3), **kw)
    np.testing.assert_array_equal(rtop["indices"], rwant["indices"])
    np.testing.assert_allclose(rtop["values"], rwant["values"], rtol=0,
                               atol=ATOL)


def test_device_topk_sink_refuses_masked_runs():
    xm = _nan_x(12, 10, seed=44)
    with pytest.raises(ValueError, match="fused"):
        corr(xm, where="nan", t=8, l_blk=8, sink=DeviceTopKSink(3),
             device="cpu")


def test_masked_runs_launch_every_component_per_pass(monkeypatch):
    """Six component streams per pass for Pearson (three for cosine, four
    for covariance); on the triangle, sxy and n take the single-operand
    launch and the cross components a same-shape second operand."""
    calls = []

    def counted(u, j0, **kw):
        calls.append(kw.get("v_pad") is None)
        return pcc_tiles(u, j0, **kw)
    monkeypatch.setattr(allpairs, "pcc_tiles", counted)
    xm = _nan_x(37, 20, seed=45)
    plan = ExecutionPlan.create(37, 20, t=8, l_blk=8, max_tiles_per_pass=4,
                                measure="dot")
    for measure in MEASURES:
        comps = measures.get_masked(measure).components
        calls.clear()
        corr(xm, where="nan", measure=measure, t=8, l_blk=8,
             max_tiles_per_pass=4, device="cpu")
        assert len(calls) == len(comps) * plan.n_pass
        single = sum(c in ("sxy", "n") for c in comps)
        assert sum(calls) == single * plan.n_pass


def test_masked_operands_bitwise_equal_reference():
    xm = _nan_x(19, 13, seed=46)
    xm[3, 5] = np.inf            # nan_to_num maps it to the largest float
    mask = ~np.isnan(xm)
    mask[4, 6] = False           # an observed value masked out
    got = measures.masked_operands(torch.from_numpy(xm),
                                   torch.from_numpy(mask))
    want = ref_measures.masked_operands(jnp.asarray(xm), jnp.asarray(mask))
    assert set(got) == set(want) == {"a", "m", "a2"}
    for k in got:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert measures.MASKED_COMPONENT_OPERANDS == \
        ref_measures.MASKED_COMPONENT_OPERANDS
    for name in ("pearson", "pcc", "cosine", "cov", "covariance_complete"):
        ours, ref = measures.get_masked(name), ref_measures.get_masked(name)
        assert (ours.name, ours.base, ours.components, ours.clip) == \
            (ref.name, ref.base, ref.components, ref.clip)
    assert measures.MASKED_NAMES == ("cosine_complete", "covariance_complete",
                                     "pearson_complete")


@pytest.mark.parametrize("measure", MEASURES)
def test_masked_dense_reference_matches_reference(measure):
    xm, ym = _nan_x(21, 17, seed=47), _nan_x(9, 17, seed=48)
    mx, my = ~np.isnan(xm), ~np.isnan(ym)
    for y, m_y in ((None, None), (ym, my)):
        got = measures.masked_dense_reference(
            torch.from_numpy(xm), torch.from_numpy(mx),
            None if y is None else torch.from_numpy(y),
            None if m_y is None else torch.from_numpy(m_y), measure)
        want = ref_measures.masked_dense_reference(
            jnp.asarray(xm), jnp.asarray(mx),
            None if y is None else jnp.asarray(y),
            None if m_y is None else jnp.asarray(m_y), measure)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)
        tiled = corr(xm, y, where="nan" if y is None else (None, None),
                     measure=measure, t=8, l_blk=8, device="cpu")
        np.testing.assert_allclose(tiled.numpy(), got.numpy(), rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("t,l_blk,j_start,pass_tiles", [
    (8, 8, 0, 15), (8, 8, 4, 6), (8, 8, 13, 5), (16, 8, 1, 4)])
def test_triangle_second_operand_tiles_match_reference(t, l_blk, j_start,
                                                       pass_tiles):
    rng = np.random.default_rng(49)
    n, l = 37, 20
    a = rng.standard_normal((n, l)).astype(np.float32)
    m = (rng.random((n, l)) > 0.3).astype(np.float32)
    u, v = (pad_operands(torch.from_numpy(z), t, l_blk) for z in (a, m))
    got = pcc_tiles_plain(u, j_start, t=t, l_blk=l_blk,
                          pass_tiles=pass_tiles, v_pad=v)
    want = ref_pcc_tiles(jnp.asarray(u.numpy()), j_start, t=t, l_blk=l_blk,
                         pass_tiles=pass_tiles, interpret=True,
                         v_pad=jnp.asarray(v.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    # the wrapper on CPU tensors is the plain version
    assert torch.equal(pcc_tiles(u, j_start, t=t, l_blk=l_blk,
                                 pass_tiles=pass_tiles, v_pad=v), got)
    # a triangle tile is the grid tile at the same (y, x)
    mt = u.shape[0] // t
    grid = pcc_tiles_plain(u, 0, t=t, l_blk=l_blk, pass_tiles=mt * mt,
                           v_pad=v, grid_cols=mt)
    from repro_torch.core.mapping import job_coord_batch
    total = mt * (mt + 1) // 2
    ys, xs = job_coord_batch(mt, np.minimum(
        j_start + np.arange(pass_tiles), total - 1))
    assert torch.equal(got, grid[torch.as_tensor(ys * mt + xs)])
    with pytest.raises(ValueError, match="matches u_pad exactly"):
        pcc_tiles_plain(u, 0, t=t, l_blk=l_blk, pass_tiles=1, v_pad=v[:t])
    with pytest.raises(ValueError, match="dtype"):
        pcc_tiles_plain(u, 0, t=t, l_blk=l_blk, pass_tiles=1,
                        v_pad=v.to(torch.bfloat16))


def test_masked_sink_plan_is_the_component_plan_unfused():
    from repro_torch.core.api import masked_sink_plan
    plan = ExecutionPlan.create(20, 12, t=8, l_blk=8, measure="dot",
                                clip=False)
    sp = masked_sink_plan(plan, measures.MASKED_COVARIANCE, True)
    assert sp.measure.name == "covariance_complete" and sp.measure.clip is None
    assert not sp.fused and sp.clip and sp.l_pad == plan.l_pad
    assert dataclasses.replace(sp, measure=plan.measure, fused=True,
                               clip=False) == plan
