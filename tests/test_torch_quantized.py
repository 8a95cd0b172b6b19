"""Port parity of the quantized operands: per-row absmax int8 and fp8
(``float8_e4m3fn``, ``float8_e5m2``) through quantize_rows, plan.prepare,
the scaled tile kernel's plain version, corr and the sinks, against
``repro`` on the CPU.

Tolerances:
- quantize_rows, prepared data, the dequant oracle's integer products and
  Kendall's int8: bitwise (the same float32 arithmetic, round half to even
  and round-to-nearest-even casts in both packages);
- tiles and corr against the reference, 3e-6 (relative to max |r| for
  covariance and dot): the same exact products (int8 x int8 in integers,
  fp8 x fp8 exact in float32) summed in float32 in different orders, then
  one multiply by the same scale product;
- quantized against float32 corr: the reference's own error budgets
  (tests/test_quantized.py), on its adversarial inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import measures as ref_measures
from repro.core import quantize as ref_quantize
from repro.core.api import corr as ref_corr
from repro.core.plan import ExecutionPlan as RefPlan
from repro.core.plan import needs_row_scales as ref_needs_row_scales
from repro.core.sinks import TopKSink as RefTopKSink
from repro.kernels.pcc_tile import EpilogueSpec as RefEpilogue
from repro.kernels.pcc_tile import pcc_tiles as ref_pcc_tiles
from repro_torch import convert
from repro_torch.core import measures, quantize
from repro_torch.core.allpairs import execute_plan
from repro_torch.core.api import corr
from repro_torch.core.plan import (ExecutionPlan, needs_row_scales,
                                   pad_operands, pad_scales)
from repro_torch.core.quantize import Operand, operand_parts, quantize_rows
from repro_torch.core.sinks import DeviceTopKSink, TopKSink
from repro_torch.kernels.pcc_tile import (EpilogueSpec, pcc_tiles,
                                          pcc_tiles_plain)

ATOL = 3e-6
QDTYPES = ["int8", "float8_e4m3fn", "float8_e5m2"]
MEASURES = ["pearson", "spearman", "cosine", "covariance"]
T, LBLK = 8, 8


def _adversarial(n=24, l=96, seed=42):
    """The reference's absmax stress rows: a constant row, a near-constant
    row, a row whose +/-1e4 outliers dwarf every other sample, a tiny row,
    sparse spikes."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, l)).astype(np.float32)
    x[0] = 3.25
    x[1] = 1.0 + 1e-6 * rng.standard_normal(l)
    x[2, 0], x[2, 1] = 1e4, -1e4
    x[3] *= 1e-5
    x[4, ::7] = 50.0
    return x


def _x(n, l, seed=0):
    """Normal data scaled by 1/sqrt(l) (covariance and dot stay O(1))."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, l)) / np.sqrt(l)).astype(np.float32)


def _bits(a) -> np.ndarray:
    """Bit patterns of a tensor or a numpy array (fp8 as uint8)."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.uint8).numpy() if a.element_size() == 1 \
            else a.numpy()
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a


def _max_err(got, want, relative):
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    return err / max(float(np.abs(np.asarray(want)).max()), 1.0) \
        if relative else err


# -- quantize_rows and the operand -----------------------------------------------


@pytest.mark.parametrize("qdtype", QDTYPES)
def test_quantize_rows_bitwise_equal_reference(qdtype):
    for u in (_adversarial(), np.zeros((3, 16), np.float32),
              np.random.default_rng(1).standard_normal((64, 300))
              .astype(np.float32)):
        q, s = quantize_rows(torch.from_numpy(u), qdtype)
        rq, rs = ref_quantize.quantize_rows(jnp.asarray(u), qdtype)
        assert str(q.dtype) == f"torch.{qdtype}" and s.dtype == torch.float32
        np.testing.assert_array_equal(_bits(q), _bits(rq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    zq, zs = quantize_rows(torch.zeros(3, 16), qdtype)
    assert not zs.any() and not zq.to(torch.float32).any()


@pytest.mark.parametrize("qdtype", QDTYPES)
@pytest.mark.parametrize("measure", ["pearson", "kendall"])
def test_prepared_operands_bitwise_equal_reference(qdtype, measure):
    """Data and scales of plan.prepare / prepare_pair, quantized from the
    reference's own transform (the port's float32 transform may differ from
    it in the last bit, which moves an absmax scale)."""
    x, y = _x(37, 12, seed=2), _x(21, 12, seed=3)
    kw = dict(t=T, l_blk=LBLK, measure=measure, compute_dtype=qdtype)
    ref = RefPlan.create(37, 12, n_cols=21, **kw)
    plan = ExecutionPlan.create(37, 12, n_cols=21, **kw)
    assert plan.spec_dict() == ref.spec_dict()
    if measure == "kendall" and qdtype == "int8":   # exact: no scales
        assert not plan.scaled
        return
    assert plan.scaled
    for got, want in zip(plan.prepare_pair(torch.from_numpy(x),
                                           torch.from_numpy(y)),
                         ref.prepare_pair(jnp.asarray(x), jnp.asarray(y))):
        assert isinstance(got, Operand)
        assert got.shape == want.shape and got.scale.shape == want.scale.shape
        if measure == "kendall":   # exact transforms: the same bits
            np.testing.assert_array_equal(_bits(got.data), _bits(want.data))
            np.testing.assert_array_equal(got.scale.numpy(),
                                          np.asarray(want.scale))
    u = ref_measures.get(measure).transform(jnp.asarray(x),
                                            dtype=jnp.float32)
    rq, rs = ref_quantize.quantize_rows(u, qdtype)
    q, s = quantize_rows(torch.from_numpy(np.array(u)), qdtype)
    want_q = pad_operands(torch.from_numpy(_bits(rq).copy()), T, LBLK)
    np.testing.assert_array_equal(_bits(pad_operands(q, T, LBLK)),
                                  want_q.numpy())
    np.testing.assert_array_equal(pad_scales(s, T).numpy(),
                                  np.pad(np.asarray(rs), (0, 3)))


def test_operand_plumbing_and_slicing():
    plan = ExecutionPlan.create(8, 24, t=T, l_blk=LBLK, compute_dtype="int8")
    u = plan.prepare(torch.from_numpy(_adversarial(8, 24)))
    assert isinstance(u, Operand)
    data, scale = operand_parts(u)
    assert data.dtype == torch.int8 and scale.shape == (data.shape[0],)
    assert u.shape == data.shape and u.dtype == torch.int8 and u.ndim == 2
    sub = u[:5]
    assert sub.data.shape[0] == 5 and sub.scale.shape == (5,)
    d2, s2 = operand_parts(data)
    assert d2 is data and s2 is None
    assert quantize.operand_data(u) is data
    assert quantize.operand_data(data) is data


def test_needs_row_scales_matrix_equals_reference():
    for name in ("pearson", "spearman", "cosine", "covariance", "dot",
                 "kendall", "kendall_tau_b", "kendall_sign_gemm"):
        for cd in (None, "bfloat16", "int8", "float8_e4m3fn", "float8_e5m2"):
            assert needs_row_scales(measures.get(name), cd) == \
                ref_needs_row_scales(ref_measures.get(name), cd), (name, cd)
            assert needs_row_scales(
                measures.get(name), None if cd is None else
                getattr(torch, cd)) == needs_row_scales(measures.get(name),
                                                        cd)


def test_fp8_probe_is_cached_and_consistent():
    for name in ("float8_e4m3fn", "float8_e5m2"):
        assert quantize.fp8_supported(name) is quantize.fp8_supported(name)
        assert quantize.fp8_supported(name) == ref_quantize.fp8_supported(
            name)
    assert not quantize.fp8_supported("float8_nonexistent")
    d = quantize.fp8_dtype()
    assert d is None or quantize.fp8_supported(str(d).removeprefix("torch."))
    assert quantize.is_fp8(torch.float8_e5m2) and not quantize.is_fp8("int8")


def test_fp8_plan_raises_when_unsupported(monkeypatch):
    monkeypatch.setattr(quantize, "fp8_supported", lambda name: False)
    for cd in (torch.float8_e4m3fn, "float8_e5m2"):
        with pytest.raises(ValueError, match="probed"):
            ExecutionPlan.create(16, 32, t=T, l_blk=LBLK, compute_dtype=cd)
        with pytest.raises(ValueError, match="probed"):
            corr(_x(16, 32), t=T, l_blk=LBLK, compute_dtype=cd, device="cpu")
    # int8 needs no probe
    assert ExecutionPlan.create(16, 32, compute_dtype="int8").scaled


# -- the scaled tile kernel's plain version --------------------------------------


@pytest.mark.parametrize("qdtype", QDTYPES)
@pytest.mark.parametrize("grid", [False, True])
@pytest.mark.parametrize("spec", [None, EpilogueSpec(clip=(-1.0, 1.0)),
                                  EpilogueSpec(div=7.0, clip=(-0.05, 0.05))])
def test_scaled_plain_tiles_match_reference(qdtype, grid, spec):
    n, n_cols, l, t, l_blk = 37, 21, 29, 8, 8
    kw = dict(t=t, l_blk=l_blk, compute_dtype=qdtype)
    ref_plan = RefPlan.create(n, l, n_cols=n_cols if grid else None, **kw)
    x, y = jnp.asarray(_x(n, l, 4)), jnp.asarray(_x(n_cols, l, 5))
    if grid:
        ru, rv = ref_plan.prepare_pair(x, y)
    else:
        ru, rv = ref_plan.prepare(x), None
    u = convert.operand_from_reference(ru, device="cpu")
    v = None if rv is None else convert.operand_from_reference(rv,
                                                               device="cpu")
    gc = ref_plan.workload.grid_cols
    col = u if v is None else v
    ref_spec = None if spec is None else RefEpilogue(spec.div, spec.clip)
    for j0, tiles in ((0, ref_plan.total_tiles), (3, 5),
                      (ref_plan.total_tiles - 2, 4)):
        got = pcc_tiles_plain(u.data, j0, t=t, l_blk=l_blk, pass_tiles=tiles,
                              epilogue=spec, v_pad=None if v is None
                              else v.data, grid_cols=gc, row_scale=u.scale,
                              col_scale=col.scale)
        want = ref_pcc_tiles(ru.data, j0, t=t, l_blk=l_blk, pass_tiles=tiles,
                             interpret=True, epilogue=ref_spec,
                             v_pad=None if rv is None else rv.data,
                             grid_cols=gc, row_scale=ru.scale,
                             col_scale=(ru if rv is None else rv).scale)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)
        if qdtype == "int8":   # integer sums: the same bits
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        # the scale product runs after the sum and before the epilogue
        raw = pcc_tiles_plain(u.data, j0, t=t, l_blk=l_blk, pass_tiles=tiles,
                              v_pad=None if v is None else v.data,
                              grid_cols=gc)
        m = u.shape[0] // t
        total = ref_plan.total_tiles
        ids = np.minimum(j0 + np.arange(tiles), total - 1)
        ys, xs = (divmod(ids, gc) if gc else
                  __import__("repro_torch.core.mapping", fromlist=["x"])
                  .job_coord_batch(m, ids))
        prod = (u.scale.view(m, t)[torch.as_tensor(ys)][:, :, None]
                * col.scale.view(-1, t)[torch.as_tensor(xs)][:, None, :])
        want2 = raw * prod
        if spec is not None:
            want2 = spec.apply(want2)
        assert torch.equal(got, want2)
        # a CPU tensor runs the plain version
        assert torch.equal(pcc_tiles(u.data, j0, t=t, l_blk=l_blk,
                                     pass_tiles=tiles, epilogue=spec,
                                     v_pad=None if v is None else v.data,
                                     grid_cols=gc, row_scale=u.scale,
                                     col_scale=col.scale), got)


def test_scaled_wrapper_checks_its_scales():
    u = torch.zeros(16, 8, dtype=torch.int8)
    s = torch.ones(16)
    kw = dict(t=8, l_blk=8, pass_tiles=2)
    with pytest.raises(ValueError, match="together"):
        pcc_tiles(u, 0, row_scale=s, **kw)
    with pytest.raises(ValueError, match="together"):
        pcc_tiles(u, 0, col_scale=s, **kw)
    for bad in (torch.ones(8), s.double(), s[None], torch.ones(32)[::2]):
        with pytest.raises(ValueError, match="row_scale"):
            pcc_tiles(u, 0, row_scale=bad, col_scale=s, **kw)
    with pytest.raises(ValueError, match="col_scale"):
        pcc_tiles(u, 0, v_pad=torch.zeros(24, 8, dtype=torch.int8),
                  grid_cols=3, row_scale=s, col_scale=s, **kw)
    with pytest.raises(ValueError, match="float8"):
        pcc_tiles(u.to(torch.float64), 0, **kw)


# -- corr ----------------------------------------------------------------------


@pytest.mark.parametrize("qdtype", QDTYPES)
@pytest.mark.parametrize("measure", MEASURES)
def test_quantized_corr_matches_reference(measure, qdtype):
    x, y = _x(37, 29, seed=6), _x(21, 29, seed=7)
    kw = dict(measure=measure, t=T, l_blk=LBLK, max_tiles_per_pass=4,
              compute_dtype=qdtype)
    rel = measure == "covariance"
    for yy in (None, y):
        got = corr(x, yy, device="cpu", **kw)
        want = ref_corr(jnp.asarray(x), None if yy is None
                        else jnp.asarray(yy), **kw)
        assert _max_err(got.numpy(), want, rel) <= ATOL
        if yy is None:
            assert torch.equal(got, got.T)
        # torch dtypes and names select the same path; the split changes
        # no bit
        assert torch.equal(got, corr(x, yy, device="cpu", **{
            **kw, "compute_dtype": getattr(torch, qdtype),
            "max_tiles_per_pass": None}))


@pytest.mark.parametrize("tag", ["int8", "fp8"])
@pytest.mark.parametrize("measure", MEASURES)
def test_error_budgets_of_the_reference(measure, tag):
    """Quantized against float32 corr on the adversarial rows, within the
    reference's pinned budgets (int8, and float8_e4m3fn, its fp8 type).

    Parity with the reference on these rows runs from the reference's own
    prepared operand: the near-constant row's float32 transform is
    ill-conditioned (its centred values are float32 rounding residue of the
    mean), so the two packages' transforms of it differ by ~1e-2 already
    unquantized, whatever the compute dtype."""
    budgets = {"int8": {"pearson": 8e-3, "spearman": 8e-3, "cosine": 8e-3,
                        "covariance": 1e-4},
               "fp8": {"pearson": 5e-2, "spearman": 5e-2, "cosine": 5e-2,
                       "covariance": 5e-4}}
    x = _adversarial()
    r32 = corr(x, measure=measure, t=T, l_blk=LBLK, device="cpu").numpy()
    for cd in (["int8"] if tag == "int8"
               else ["float8_e4m3fn", "float8_e5m2"]):
        r = corr(x, measure=measure, t=T, l_blk=LBLK, compute_dtype=cd,
                 device="cpu").numpy()
        err = _max_err(r, r32, measure == "covariance")
        if tag == "int8" or cd == "float8_e4m3fn":   # the reference's cases
            assert err <= budgets[tag][measure], (cd, err)
        ref_plan = RefPlan.create(*x.shape, t=T, l_blk=LBLK, measure=measure,
                                  compute_dtype=cd)
        got = execute_plan(
            convert.plan_from_reference(ref_plan.spec_dict()),
            convert.operand_from_reference(ref_plan.prepare(jnp.asarray(x)),
                                           device="cpu"), device="cpu")
        want = ref_corr(jnp.asarray(x), measure=measure, t=T, l_blk=LBLK,
                        compute_dtype=cd)
        assert _max_err(got.numpy(), want, measure == "covariance") <= ATOL


def test_int8_matches_dequant_dense_oracle():
    """The tiled int8 path is the dense dequantized product: integer dot
    products, then the scale product and the clip."""
    x = _adversarial(16, 48)
    u = measures.PEARSON.transform(torch.from_numpy(x), dtype=torch.float32)
    q, s = quantize_rows(u, "int8")
    raw = q.double() @ q.double().T          # exact integers
    oracle = torch.clamp(raw.float() * (s[:, None] * s[None, :]), -1.0, 1.0)
    got = corr(x, t=T, l_blk=LBLK, compute_dtype=torch.int8, device="cpu")
    torch.testing.assert_close(got, oracle, rtol=0, atol=1e-6)
    assert torch.equal(got, oracle)


@pytest.mark.parametrize("l", [5, 13])
def test_kendall_int8_unchanged(l):
    """Kendall's exact pair signs keep their unscaled int8 operand, bitwise
    the float32 sign-GEMM and the reference; fp8 quantizes them with row
    scales (the reference does too)."""
    x = _x(37, l, seed=8)
    kw = dict(measure="kendall", t=T, l_blk=LBLK, max_tiles_per_pass=4)
    plan = ExecutionPlan.create(37, l, compute_dtype="int8", **{
        k: v for k, v in kw.items() if k != "max_tiles_per_pass"})
    u = plan.prepare(torch.from_numpy(x))
    assert not plan.scaled and isinstance(u, torch.Tensor)
    got = corr(x, compute_dtype="int8", device="cpu", **kw)
    assert torch.equal(got, corr(x, device="cpu", **kw))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_corr(
        jnp.asarray(x), compute_dtype="int8", **kw)))
    f8 = corr(x, compute_dtype="float8_e4m3fn", device="cpu", **kw)
    np.testing.assert_allclose(f8.numpy(), np.asarray(ref_corr(
        jnp.asarray(x), compute_dtype="float8_e4m3fn", **kw)), rtol=0,
        atol=ATOL)


@pytest.mark.parametrize("qdtype", QDTYPES)
def test_topk_sinks_on_quantized_runs(qdtype):
    x = _x(30, 20, seed=9)
    kw = dict(t=T, l_blk=LBLK, max_tiles_per_pass=3, compute_dtype=qdtype)
    top = corr(x, sink=TopKSink(4), device="cpu", **kw)
    want = ref_corr(jnp.asarray(x), sink=RefTopKSink(4), **kw)
    np.testing.assert_array_equal(top["indices"], want["indices"])
    np.testing.assert_allclose(top["values"], want["values"], rtol=0,
                               atol=ATOL)
    plan = ExecutionPlan.create(30, 20, **kw)
    assert not DeviceTopKSink.supports(plan)
    with pytest.raises(ValueError, match="quantized"):
        corr(x, sink=DeviceTopKSink(4), device="cpu", **kw)
    with pytest.raises(ValueError, match="quantized"):
        corr(x, _x(9, 20, seed=10), sink=DeviceTopKSink(4), device="cpu",
             **kw)
    assert DeviceTopKSink.supports(ExecutionPlan.create(
        30, 20, measure="kendall", compute_dtype="int8"))


# -- state conversion and the executor ---------------------------------------------


@pytest.mark.parametrize("qdtype", QDTYPES)
@pytest.mark.parametrize("n_cols", [None, 21])
def test_convert_round_trips_quantized_plans_and_operands(qdtype, n_cols):
    x, y = _x(37, 10, seed=11), _x(21, 10, seed=12)
    kw = dict(n_cols=n_cols, t=T, l_blk=LBLK, measure="cosine",
              compute_dtype=qdtype, max_tiles_per_pass=5)
    ref_plan = RefPlan.create(37, 10, **kw)
    plan = convert.plan_from_reference(ref_plan.spec_dict())
    assert plan.spec_dict() == ref_plan.spec_dict() and plan.scaled
    assert plan.compute_dtype == getattr(torch, qdtype)
    ref_ops = ((ref_plan.prepare(jnp.asarray(x)),) if n_cols is None
               else ref_plan.prepare_pair(jnp.asarray(x), jnp.asarray(y)))
    ops = [convert.operand_from_reference(u, device="cpu") for u in ref_ops]
    for got, want in zip(ops, ref_ops):
        assert isinstance(got, Operand) and got.dtype == plan.compute_dtype
        np.testing.assert_array_equal(_bits(got.data), _bits(want.data))
        np.testing.assert_array_equal(got.scale.numpy(),
                                      np.asarray(want.scale))
        # the bare data converts as a plain tensor
        assert torch.equal(convert.operand_from_reference(
            np.asarray(want.data), device="cpu").view(torch.uint8),
            got.data.view(torch.uint8))
    r = execute_plan(plan, *ops, device="cpu")
    want = ref_corr(jnp.asarray(x), None if n_cols is None else jnp.asarray(y),
                    **{k: v for k, v in kw.items() if k != "n_cols"})
    np.testing.assert_allclose(r.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_execute_plan_checks_quantized_operands():
    plan = ExecutionPlan.create(16, 8, t=T, l_blk=LBLK, compute_dtype="int8")
    u = plan.prepare(torch.from_numpy(_x(16, 8)))
    with pytest.raises(ValueError, match="Operand"):
        execute_plan(plan, u.data, device="cpu")
    with pytest.raises(ValueError, match="scales"):
        execute_plan(plan, Operand(u.data, u.scale[:8]), device="cpu")
    with pytest.raises(ValueError, match="Operand"):
        execute_plan(ExecutionPlan.create(16, 8, t=T, l_blk=LBLK), u,
                     device="cpu")
    with pytest.raises(ValueError, match="same plan"):
        from repro_torch.core.allpairs import launch_tiles
        rplan = ExecutionPlan.create(16, 8, n_cols=16, t=T, l_blk=LBLK,
                                     compute_dtype="int8")
        launch_tiles(rplan, u, 0, 2, u.data)
    with pytest.raises(ValueError, match="fp8"):
        convert.operand_from_reference(np.zeros((8, 8), np.float64),
                                       device="cpu")
