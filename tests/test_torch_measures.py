"""Port parity of the measure space: every row transform, every ported
measure's ``corr`` (symmetric and X-vs-Y, multi-pass with a ragged last
pass, fused and unfused), the plan identity, the refusals where the
reference would take a path that is not ported yet, and custom measures.

Tolerances: ``rank_rows`` and ``pair_sign_transform`` match bitwise (ties
included), so does Kendall tau-a (integer pair counts, one division).  The
rest match within 3e-6, the reference's own Pearson parity bound
(tests/test_distributed.py): both sum the same float32 products in
different orders.  The data is scaled by 1/sqrt(l) so that the unbounded
measures (dot, covariance) stay O(1), where 3e-6 is a float32 statement.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import measures as ref_measures
from repro.core.api import corr as ref_corr
from repro.core.plan import ExecutionPlan as RefPlan
from repro_torch.core import measures
from repro_torch.core.api import corr
from repro_torch.core.plan import ExecutionPlan

ATOL = 3e-6
MEASURES = ["pearson", "spearman", "cosine", "covariance", "dot", "kendall",
            "kendall_tau_b"]
# (n, n_cols, l, t, l_blk, max_tiles_per_pass): n and n_cols never a
# multiple of t, several passes with a ragged last one
CASES = [(37, 21, 12, 8, 8, 4), (30, 17, 9, 8, 8, 5)]


def _x(n, l, seed=0, ties=True):
    """Normal data scaled by 1/sqrt(l), with a zero row, a constant row and
    (ties=True) repeated values in other rows; rounded to multiples of 1/64
    in two rows so ranks and pair signs see exact ties."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, l)) / np.sqrt(l)).astype(np.float32)
    x[3] = 0.0
    x[n - 2] = 0.375
    if ties:
        x[1, : l // 2] = x[1, 0]
        x[5] = np.round(x[5] * 8) / 8
        x[7] = np.round(x[7] * 64) / 64
    return x


# -- transforms --------------------------------------------------------------


@pytest.mark.parametrize("name", ["rank_rows", "pair_sign_transform"])
@pytest.mark.parametrize("n,l", [(9, 2), (12, 7), (30, 40)])
def test_exact_transforms_bitwise_equal_reference(name, n, l):
    x = _x(n, l, seed=n)
    got = getattr(measures, name)(torch.from_numpy(x))
    want = np.asarray(getattr(ref_measures, name)(jnp.asarray(x)))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_rank_rows_average_ties():
    r = measures.rank_rows(torch.tensor([[3.0, 1.0, 3.0, 2.0, 3.0]]))
    assert r.tolist() == [[4.0, 1.0, 4.0, 2.0, 4.0]]
    assert torch.equal(measures.pair_sign_transform(
        torch.tensor([[1.0, 3.0, 3.0]])), torch.tensor([[-1.0, -1.0, 0.0]]))


@pytest.mark.parametrize("name", ["spearman_transform", "l2_normalize_rows",
                                  "center_rows",
                                  "pair_sign_tie_scaled_transform",
                                  "identity_transform"])
def test_transforms_match_reference(name):
    x = _x(30, 11, seed=2)
    got = getattr(measures, name)(torch.from_numpy(x), dtype=torch.float32)
    want = np.asarray(getattr(ref_measures, name)(jnp.asarray(x),
                                                  dtype=jnp.float32))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    with pytest.raises(ValueError):
        getattr(measures, name)(torch.zeros(3))


# -- corr over every measure ---------------------------------------------------


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("rect", [False, True])
@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("case", CASES[:1])
def test_corr_matches_reference(case, measure, rect, fuse):
    n, n_cols, l, t, l_blk, mtp = case
    x = _x(n, l, seed=3)
    y = _x(n_cols, l, seed=4) if rect else None
    kw = dict(measure=measure, t=t, l_blk=l_blk, max_tiles_per_pass=mtp,
              fuse_epilogue=fuse)
    got = corr(x, y, device="cpu", **kw)
    want = np.asarray(ref_corr(jnp.asarray(x),
                               None if y is None else jnp.asarray(y), **kw))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    if not rect:
        assert torch.equal(got, got.T)
    # the result depends neither on the pass split nor on fusion
    assert torch.equal(got, corr(x, y, device="cpu", **{
        **kw, "max_tiles_per_pass": None, "fuse_epilogue": not fuse}))


@pytest.mark.parametrize("measure", ["spearman", "covariance", "kendall"])
def test_corr_matches_reference_second_shape(measure):
    n, n_cols, l, t, l_blk, mtp = CASES[1]
    x, y = _x(n, l, seed=5), _x(n_cols, l, seed=6)
    kw = dict(measure=measure, t=t, l_blk=l_blk, max_tiles_per_pass=mtp)
    for yy in (None, y):
        got = corr(x, yy, device="cpu", **kw)
        want = ref_corr(jnp.asarray(x),
                        None if yy is None else jnp.asarray(yy), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("measure", ["kendall", "kendall_sign_gemm"])
def test_kendall_tau_a_bitwise_equal_reference(measure):
    x = _x(37, 12, seed=7)
    kw = dict(measure=measure, t=8, l_blk=8, max_tiles_per_pass=4)
    got = corr(x, device="cpu", **kw)
    want = np.asarray(ref_corr(jnp.asarray(x), **kw))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("measure", MEASURES)
def test_dense_references_match_reference(measure):
    x, y = _x(20, 10, seed=8), _x(13, 10, seed=9)
    got = measures.dense_reference(torch.from_numpy(x), measure)
    want = ref_measures.dense_reference(jnp.asarray(x), measure)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    got = measures.dense_reference_pair(torch.from_numpy(x),
                                        torch.from_numpy(y), measure)
    want = ref_measures.dense_reference_pair(jnp.asarray(x), jnp.asarray(y),
                                             measure)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    with pytest.raises(ValueError, match="sample counts"):
        measures.dense_reference_pair(torch.from_numpy(x),
                                      torch.from_numpy(y[:, :5]), measure)


# -- plan identity ---------------------------------------------------------------


@pytest.mark.parametrize("measure,l,compute_dtype", [
    ("pearson", 29, None), ("spearman", 29, "bfloat16"),
    ("cov", 29, None), ("dot", 29, "bfloat16"), ("kendall", 12, None),
    ("kendall", 12, "int8"), ("kendall_tau_a", 120, "int8"),
    ("kendall_b", 120, "bfloat16"), ("kendall_sign_gemm", 100, None),
    ("kendall_tau_b_sign_gemm", 12, None), ("cosine", 29, None),
])
@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("n_cols", [None, 21])
def test_spec_dict_equals_reference(measure, l, compute_dtype, fuse, n_cols):
    kw = dict(n_cols=n_cols, t=8, l_blk=8, measure=measure,
              max_tiles_per_pass=4, fuse_epilogue=fuse,
              compute_dtype=compute_dtype)
    got = ExecutionPlan.create(37, l, **kw).spec_dict()
    assert got == RefPlan.create(37, l, **kw).spec_dict()
    assert list(got) == list(RefPlan.create(37, l, **kw).spec_dict())


def _kernel_name(meas):
    return None if meas.tile_kernel is None else meas.tile_kernel.__name__


def test_registry_and_aliases():
    assert measures.get("pcc") is measures.PEARSON
    assert measures.get("cov") is measures.COVARIANCE
    assert measures.get("kendall_tau_a") is measures.KENDALL
    assert measures.get("kendall_b") is measures.KENDALL_B
    assert measures.get(measures.DOT) is measures.DOT
    assert measures.get("kendall_merge") is measures.KENDALL_MERGE
    assert set(measures.available()) == set(ref_measures.available())
    for name in measures.available():
        ours, ref = measures.get(name), ref_measures.get(name)
        # a custom tile kernel is a function of each package, the same by
        # name (the name spec_dict() carries)
        assert (ours.clip, ours.fusable, ours.exact_int8, ours.permute_gather,
                _kernel_name(ours)) == (ref.clip, ref.fusable,
                                        ref.exact_int8, ref.permute_gather,
                                        _kernel_name(ref))
        for l in (2, 7, 100):
            a, b = ours.fused_spec(l), ref.fused_spec(l)
            assert (a.div, a.clip) == (b.div, b.clip)
    v = torch.tensor([-9.0, -0.25, 0.0, 0.75, 40.0])
    assert torch.equal(measures.COVARIANCE.finalize(v, 5),
                       measures.COVARIANCE.fused_spec(5).apply(v))
    with pytest.raises(ValueError, match="unknown measure"):
        measures.get("nope")


# -- refusals: paths the reference takes that are not ported ---------------


@pytest.mark.parametrize("kw,slice_", [
    (dict(measure="kendall", l=96), "slice 7"),
    (dict(measure="kendall_tau_b", l=130), "slice 7"),
    (dict(measure="kendall_merge", l=20), "slice 7"),
    (dict(measure="kendall_tau_b_merge", l=20), "slice 7"),
    (dict(measure="pearson", compute_dtype="int8"), "slice 6"),
    (dict(measure="spearman", compute_dtype=torch.int8), "slice 6"),
    (dict(measure="pearson", compute_dtype="float8_e4m3fn"), "slice 6"),
    (dict(measure="kendall", compute_dtype=torch.float8_e5m2), "slice 6"),
])
def test_unported_paths_raise_naming_their_slice(kw, slice_):
    """Both slices named here are ported now: each case holds the port
    against the reference.  Slice 7 (merge-sort Kendall, at l >= 96 and by
    name at any l): tau-a bitwise, tau-b within 1e-6 (the reference's
    1/sqrt is XLA's rsqrt, an ulp from torch's on some counts), the same
    plan identity."""
    kw = dict(kw)
    l = kw.pop("l", 12)
    x = _x(20, l, seed=10, ties=False)
    if slice_ == "slice 7":
        plan = ExecutionPlan.create(20, l, t=8, l_blk=8, **kw)
        assert plan.measure.tile_kernel is not None
        assert plan.spec_dict() == RefPlan.create(20, l, t=8, l_blk=8,
                                                  **kw).spec_dict()
        got = corr(x, t=8, l_blk=8, device="cpu", **kw).numpy()
        want = np.asarray(ref_corr(jnp.asarray(x), t=8, l_blk=8, **kw))
        if "tau_b" in kw["measure"]:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, want)
        return
    if slice_ == "slice 6":
        # ported: quantized operands with row scales match the reference
        plan = ExecutionPlan.create(20, l, t=8, l_blk=8, **kw)
        assert plan.scaled
        got = corr(x, t=8, l_blk=8, device="cpu", **kw)
        ref_kw = {**kw, "compute_dtype": str(kw["compute_dtype"])
                  .removeprefix("torch.")}
        want = ref_corr(jnp.asarray(x), t=8, l_blk=8, **ref_kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)
        return
    raise AssertionError(f"no case for {slice_}")


def test_kendall_at_crossover_takes_the_sign_gemm_where_the_reference_does():
    x = _x(20, 96, seed=11, ties=False)
    # below the crossover, pinned by name, or with a compute_dtype, the
    # reference itself runs the sign-GEMM
    for kw in (dict(measure="kendall_sign_gemm"),
               dict(measure="kendall", compute_dtype="int8")):
        got = corr(x, t=8, l_blk=512, device="cpu", **kw)
        want = ref_corr(jnp.asarray(x), t=8, l_blk=512, **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert measures.resolve_tile_kernel(measures.KENDALL, l=95) is \
        measures.KENDALL
    assert measures.resolve_tile_kernel(measures.KENDALL_B, l=500,
                                        compute_dtype=torch.bfloat16) is \
        measures.KENDALL_B
    assert measures.resolve_tile_kernel(measures.PEARSON, l=500) is \
        measures.PEARSON


def test_unported_compute_dtypes_raise():
    # float16 (any measure) and int16 (exact_int8 measures) are ported
    assert ExecutionPlan.create(20, 12, measure="pearson",
                                compute_dtype=torch.float16
                                ).compute_dtype == torch.float16
    assert ExecutionPlan.create(20, 12, measure="kendall",
                                compute_dtype="int16"
                                ).compute_dtype == torch.int16
    for dtype in (torch.float32, torch.float64, torch.int32):
        with pytest.raises(NotImplementedError, match="not ported"):
            ExecutionPlan.create(20, 12, compute_dtype=dtype)


# -- custom measures -------------------------------------------------------------


def _twice(vals, l):
    return vals * 2.0 + float(l)


def test_custom_measure_with_non_fusable_epilogue(monkeypatch):
    monkeypatch.setattr(measures, "_REGISTRY", dict(measures._REGISTRY))
    ours = measures.register(measures.Measure(
        "centered_twice", measures.center_rows, _twice, (-5.0, 30.0)),
        "ct")
    ref = ref_measures.Measure("centered_twice", ref_measures.center_rows,
                               _twice, (-5.0, 30.0))
    assert not ours.fusable and measures.get("ct") is ours
    assert "centered_twice" in measures.available()
    x, y = _x(37, 12, seed=12), _x(21, 12, seed=13)
    for yy in (None, y):
        kw = dict(t=8, l_blk=8, max_tiles_per_pass=4)
        got = corr(x, yy, measure="ct", device="cpu", **kw)
        want = ref_corr(jnp.asarray(x),
                        None if yy is None else jnp.asarray(yy), measure=ref,
                        **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=2 * ATOL)
        assert float(got.max()) <= 30.0 and float(got.min()) >= -5.0
    plan = ExecutionPlan.create(37, 12, measure=ours)
    assert not plan.fused and plan.epilogue_spec is None
    # a custom tile kernel rides the plan as in the reference, named by
    # its __name__ in the plan identity
    kplan = ExecutionPlan.create(37, 12, measure=dataclasses.replace(
        ours, tile_kernel=_twice))
    assert kplan.spec_dict()["tile_kernel"] == "_twice"
    assert kplan.spec_dict() == RefPlan.create(
        37, 12, measure=dataclasses.replace(ref, tile_kernel=_twice)
    ).spec_dict()
