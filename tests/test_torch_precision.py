"""Port parity of the narrow operand types: bfloat16, float16, int8 and
int16 operands through plan.prepare, pcc_tiles / pcc_topk_tiles (their
plain versions on the CPU), corr, the top-k sinks and the state
conversion.

Tolerances:
- prepared operands, bitwise: both narrow the same float32 transform with
  round-to-nearest-even (bfloat16 and float16 compared as their 16-bit
  patterns);
- bfloat16 and float16 corr within 1e-5 of the reference: both sum the
  same exact products (a bf16 or fp16 product is exact in float32) in
  float32, in different orders;
- int8 and int16 Kendall, bitwise: integer pair counts, exact in any order,
  and one division by the same float32 reciprocal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.api import corr as ref_corr
from repro.core.plan import ExecutionPlan as RefPlan
from repro.core.sinks import DeviceTopKSink as RefDeviceTopKSink
from repro.core.sinks import TopKSink as RefTopKSink
from repro.kernels.pcc_tile import EpilogueSpec as RefEpilogue
from repro.kernels.pcc_tile import pcc_tiles as ref_pcc_tiles
from repro.kernels.pcc_tile import pcc_topk_tiles as ref_topk_tiles
from repro_torch import convert
from repro_torch.core.allpairs import execute_plan
from repro_torch.core.api import corr
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.sinks import DeviceTopKSink, TopKSink
from repro_torch.kernels.pcc_tile import (INT8_MAX_L_PAD, EpilogueSpec,
                                          pcc_tiles, pcc_tiles_plain,
                                          pcc_topk_tiles,
                                          pcc_topk_tiles_plain)

BF16_ATOL = 1e-5
MEASURES_BF16 = ["pearson", "spearman", "cosine", "covariance", "dot",
                 "kendall", "kendall_tau_b"]


def _x(n, l, seed=0):
    """Normal data scaled by 1/sqrt(l) (unbounded measures stay O(1)), with
    a zero row, a constant row and a row of repeated values."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, l)) / np.sqrt(l)).astype(np.float32)
    x[3] = 0.0
    x[n - 2] = 0.375
    x[1, : l // 2] = x[1, 0]
    return x


def _bits(a):
    """float32 / int8 arrays as they are, bfloat16 as its 16-bit patterns."""
    if isinstance(a, torch.Tensor):
        return (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("measure,dtype", [
    ("pearson", "bfloat16"), ("spearman", "bfloat16"), ("cosine", "bfloat16"),
    ("covariance", "bfloat16"), ("dot", "bfloat16"), ("kendall", "bfloat16"),
    ("kendall_tau_b", "bfloat16"), ("kendall", "int8"),
    ("kendall_sign_gemm", "int8")])
def test_prepared_operands_bitwise_equal_reference(measure, dtype):
    x, y = _x(37, 12, seed=1), _x(21, 12, seed=2)
    kw = dict(t=8, l_blk=8, measure=measure, compute_dtype=dtype)
    plan = ExecutionPlan.create(37, 12, **kw)
    ref = RefPlan.create(37, 12, **kw)
    got = plan.prepare(torch.from_numpy(x))
    want = ref.prepare(jnp.asarray(x))
    assert str(got.dtype) == f"torch.{dtype}" and got.shape == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))
    rplan = ExecutionPlan.create(37, 12, n_cols=21, **kw)
    gu, gv = rplan.prepare_pair(torch.from_numpy(x), torch.from_numpy(y))
    wu, wv = RefPlan.create(37, 12, n_cols=21, **kw).prepare_pair(
        jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_array_equal(_bits(gu), _bits(wu))
    np.testing.assert_array_equal(_bits(gv), _bits(wv))


@pytest.mark.parametrize("rect", [False, True])
@pytest.mark.parametrize("measure", MEASURES_BF16)
def test_bf16_corr_matches_reference(measure, rect):
    x = _x(37, 12, seed=3)
    y = _x(21, 12, seed=4) if rect else None
    kw = dict(measure=measure, t=8, l_blk=8, max_tiles_per_pass=4,
              compute_dtype=torch.bfloat16)
    got = corr(x, y, device="cpu", **kw)
    want = ref_corr(jnp.asarray(x), None if y is None else jnp.asarray(y),
                    **{**kw, "compute_dtype": jnp.bfloat16})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=BF16_ATOL)
    # the bf16 result is the float32 engine run on the widened operands
    plan = ExecutionPlan.create(37, 12, n_cols=None if y is None else 21,
                                **kw)
    ops = ((plan.prepare(torch.from_numpy(x)),) if y is None else
           plan.prepare_pair(torch.from_numpy(x), torch.from_numpy(y)))
    f32 = ExecutionPlan.create(37, 12, n_cols=None if y is None else 21,
                               **{**kw, "compute_dtype": None})
    assert torch.equal(got, execute_plan(
        f32, *[u.float() for u in ops], device="cpu"))


@pytest.mark.parametrize("rect", [False, True])
@pytest.mark.parametrize("l", [2, 9, 13])
def test_int8_kendall_bitwise_equal_reference(l, rect):
    x = _x(37, l, seed=5)
    y = _x(21, l, seed=6) if rect else None
    kw = dict(measure="kendall", t=8, l_blk=8, max_tiles_per_pass=4)
    got = corr(x, y, compute_dtype="int8", device="cpu", **kw)
    want = np.asarray(ref_corr(jnp.asarray(x),
                               None if y is None else jnp.asarray(y),
                               compute_dtype=jnp.int8, **kw))
    np.testing.assert_array_equal(got.numpy(), want)
    # and bitwise the float32 sign-GEMM
    assert torch.equal(got, corr(x, y, device="cpu", **kw))


@pytest.mark.parametrize("rect", [False, True])
@pytest.mark.parametrize("mtp", [None, 3])
def test_int8_kendall_topk_sinks_bitwise_equal_reference(rect, mtp):
    x = _x(30, 11, seed=7)
    y = _x(21, 11, seed=8) if rect else None
    kw = dict(measure="kendall", t=8, l_blk=8, max_tiles_per_pass=mtp)
    jx, jy = jnp.asarray(x), None if y is None else jnp.asarray(y)
    want = ref_corr(jx, jy, sink=RefTopKSink(5), compute_dtype=jnp.int8,
                    **kw)
    for sink in (TopKSink(5), DeviceTopKSink(5)):
        got = corr(x, y, sink=sink, compute_dtype=torch.int8, device="cpu",
                   **kw)
        np.testing.assert_array_equal(got["indices"], want["indices"])
        np.testing.assert_array_equal(got["values"], want["values"])
    dev = ref_corr(jx, jy, sink=RefDeviceTopKSink(5), compute_dtype=jnp.int8,
                   **kw)
    np.testing.assert_array_equal(got["indices"], dev["indices"])
    np.testing.assert_array_equal(got["values"], dev["values"])


def test_bf16_device_topk_equals_topk_sink():
    x = _x(30, 11, seed=9)
    kw = dict(t=8, l_blk=8, compute_dtype="bfloat16", device="cpu")
    for mtp in (None, 4):
        got = corr(x, sink=DeviceTopKSink(4), max_tiles_per_pass=mtp, **kw)
        want = corr(x, sink=TopKSink(4), max_tiles_per_pass=mtp, **kw)
        np.testing.assert_array_equal(got["indices"], want["indices"])
        np.testing.assert_array_equal(got["values"], want["values"])


# -- the kernels' plain versions on narrow operands --------------------------


def _signs(n, width, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-1, 2, size=(n, width)).astype(np.int8)


@pytest.mark.parametrize("grid", [False, True])
@pytest.mark.parametrize("spec", [None, EpilogueSpec(div=66.0,
                                                     clip=(-1.0, 1.0))])
def test_plain_tiles_on_int8_bitwise_equal_reference(grid, spec):
    ref_spec = None if spec is None else RefEpilogue(div=spec.div,
                                                     clip=spec.clip)
    u = _signs(40, 64, 10)
    v = _signs(24, 64, 11) if grid else None
    kw = dict(t=8, l_blk=16, pass_tiles=7,
              grid_cols=3 if grid else None)
    got = pcc_tiles(torch.from_numpy(u), 4, epilogue=spec,
                    v_pad=None if v is None else torch.from_numpy(v), **kw)
    want = ref_pcc_tiles(jnp.asarray(u), 4, interpret=True, epilogue=ref_spec,
                         v_pad=None if v is None else jnp.asarray(v), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    kk = dict(kk=5, n_cols_valid=22 if grid else 38,
              symmetric_problem=not grid)
    got = pcc_topk_tiles(torch.from_numpy(u), 4, 10, epilogue=spec,
                         v_pad=None if v is None else torch.from_numpy(v),
                         **kw, **kk)
    want = ref_topk_tiles(jnp.asarray(u), 4, 10, interpret=True,
                          epilogue=ref_spec,
                          v_pad=None if v is None else jnp.asarray(v),
                          **kw, **kk)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_plain_int8_sums_are_exact_at_the_overflow_guard():
    """Full-range int8 rows: the plain version's float64 products are exact,
    so each tile is the integer sum rounded once to float32."""
    rng = np.random.default_rng(12)
    u = rng.integers(-128, 128, size=(16, 512), dtype=np.int8)
    u[0] = -128
    got = pcc_tiles_plain(torch.from_numpy(u), 0, t=8, l_blk=128,
                          pass_tiles=3)
    exact = u.astype(np.int64) @ u.astype(np.int64).T
    assert exact[0, 0] == 512 * 128 ** 2
    want = np.stack([exact[:8, :8], exact[:8, 8:], exact[8:, 8:]])
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
    with pytest.raises(ValueError, match="overflow"):
        pcc_tiles(torch.zeros(8, INT8_MAX_L_PAD + 1, dtype=torch.int8), 0,
                  t=8, l_blk=INT8_MAX_L_PAD + 1, pass_tiles=1)
    assert INT8_MAX_L_PAD * 128 ** 2 < 2 ** 31


def test_plain_bf16_is_the_float32_plain_on_widened_operands():
    rng = np.random.default_rng(13)
    u = torch.from_numpy(rng.standard_normal((24, 40)).astype(
        np.float32)).to(torch.bfloat16)
    v = torch.from_numpy(rng.standard_normal((16, 40)).astype(
        np.float32)).to(torch.bfloat16)
    spec = EpilogueSpec(clip=(-1.0, 1.0))
    for vv, gc in ((None, None), (v, 2)):
        kw = dict(t=8, l_blk=8, pass_tiles=5, epilogue=spec, grid_cols=gc)
        got = pcc_tiles(u, 1, v_pad=vv, **kw)
        want = pcc_tiles_plain(u.float(), 1, v_pad=None if vv is None
                               else vv.float(), **kw)
        assert torch.equal(got, want)
        tk = dict(kk=3, n_cols_valid=16 if gc else 24,
                  symmetric_problem=gc is None)
        got = pcc_topk_tiles(u, 1, 5, v_pad=vv, **kw, **tk)
        want = pcc_topk_tiles_plain(u.float(), 1, 5, v_pad=None if vv is None
                                    else vv.float(), **kw, **tk)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_wrappers_reject_mixed_and_unported_dtypes():
    u = torch.zeros(16, 8)
    kw = dict(t=8, l_blk=8, pass_tiles=2)
    for v in (torch.zeros(16, 8, dtype=torch.bfloat16),
              torch.zeros(16, 8, dtype=torch.float16),
              torch.zeros(16, 8, dtype=torch.int8)):
        with pytest.raises(ValueError, match="dtype"):
            pcc_tiles(u, 0, v_pad=v, grid_cols=2, **kw)
        with pytest.raises(ValueError, match="dtype"):
            pcc_tiles(v, 0, v_pad=u, grid_cols=2, **kw)
    # float16 is an operand type of both kernels now; int16 reaches them
    # only narrowed to int8 (plan.launch_operand), so the wrappers refuse
    # it, with float64
    assert torch.equal(pcc_tiles(u.half(), 0, **kw), pcc_tiles(u, 0, **kw))
    for bad in (torch.int16, torch.float64):
        with pytest.raises(ValueError, match="bfloat16, float16 or int8"):
            pcc_tiles(u.to(bad), 0, **kw)
        with pytest.raises(ValueError, match="bfloat16, float16 or int8"):
            pcc_topk_tiles(u.to(bad), 0, 3, kk=2, n_cols_valid=16, **kw)
    plan = ExecutionPlan.create(16, 8, t=8, l_blk=8, compute_dtype="int8",
                                measure="kendall")
    with pytest.raises(ValueError, match="int8"):
        execute_plan(plan, torch.zeros(16, plan.l_pad), device="cpu")


# -- float16 and int16 operands ------------------------------------------------
# float16 narrows the float32 transform by a cast (round to nearest even,
# as the reference's astype), so the prepared operands are bitwise equal;
# the tiles sum exact float16 x float16 products (22-bit significands fit
# float32's 24) in float32, in another order than the reference: within
# F16_ATOL of it.  int16 stores only Kendall's +/-1/0 pair signs; the
# port narrows them to int8 for the kernels, so the result is bitwise the
# reference's int32 sums.

F16_ATOL = 1e-5


def _bits16(a):
    """float16 arrays as their 16-bit patterns."""
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int16) if a.dtype == np.float16 else a


@pytest.mark.parametrize("measure", MEASURES_BF16)
def test_f16_prepared_operands_bitwise_equal_reference(measure):
    x = _x(37, 12, seed=20)
    kw = dict(t=8, l_blk=8, measure=measure, compute_dtype="float16")
    got = ExecutionPlan.create(37, 12, **kw).prepare(torch.from_numpy(x))
    want = RefPlan.create(37, 12, **{**kw, "compute_dtype": jnp.float16}
                          ).prepare(jnp.asarray(x))
    assert got.dtype == torch.float16 and got.shape == want.shape
    np.testing.assert_array_equal(_bits16(got), _bits16(want))


@pytest.mark.parametrize("rect", [False, True])
@pytest.mark.parametrize("measure", MEASURES_BF16)
def test_f16_corr_matches_reference(measure, rect):
    x = _x(37, 12, seed=21)
    y = _x(21, 12, seed=22) if rect else None
    kw = dict(measure=measure, t=8, l_blk=8, max_tiles_per_pass=4)
    got = corr(x, y, device="cpu", compute_dtype=torch.float16, **kw)
    want = ref_corr(jnp.asarray(x), None if y is None else jnp.asarray(y),
                    compute_dtype=jnp.float16, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=F16_ATOL)
    # the float16 result is the float32 engine on the widened operands
    plan = ExecutionPlan.create(37, 12, n_cols=None if y is None else 21,
                                compute_dtype="float16", **kw)
    ops = ((plan.prepare(torch.from_numpy(x)),) if y is None else
           plan.prepare_pair(torch.from_numpy(x), torch.from_numpy(y)))
    f32 = ExecutionPlan.create(37, 12, n_cols=None if y is None else 21,
                               **kw)
    assert torch.equal(got, execute_plan(
        f32, *[u.float() for u in ops], device="cpu"))


@pytest.mark.parametrize("rect", [False, True])
def test_f16_topk_sinks_match_reference(rect):
    x = _x(30, 11, seed=23)
    y = _x(21, 11, seed=24) if rect else None
    kw = dict(t=8, l_blk=8, max_tiles_per_pass=3)
    got = corr(x, y, sink=DeviceTopKSink(4), compute_dtype="float16",
               device="cpu", **kw)
    want = corr(x, y, sink=TopKSink(4), compute_dtype="float16",
                device="cpu", **kw)
    np.testing.assert_array_equal(got["indices"], want["indices"])
    np.testing.assert_array_equal(got["values"], want["values"])
    ref = ref_corr(jnp.asarray(x), None if y is None else jnp.asarray(y),
                   sink=RefDeviceTopKSink(4), compute_dtype=jnp.float16,
                   **kw)
    np.testing.assert_array_equal(got["indices"], ref["indices"])
    np.testing.assert_allclose(got["values"], ref["values"], rtol=0,
                               atol=F16_ATOL)


def test_plain_f16_is_the_float32_plain_on_widened_operands():
    rng = np.random.default_rng(25)
    u = torch.from_numpy(rng.standard_normal((24, 40)).astype(
        np.float32)).half()
    v = torch.from_numpy(rng.standard_normal((16, 40)).astype(
        np.float32)).half()
    spec = EpilogueSpec(clip=(-1.0, 1.0))
    for vv, gc in ((None, None), (v, 2)):
        kw = dict(t=8, l_blk=8, pass_tiles=5, epilogue=spec, grid_cols=gc)
        assert torch.equal(pcc_tiles(u, 1, v_pad=vv, **kw), pcc_tiles_plain(
            u.float(), 1, v_pad=None if vv is None else vv.float(), **kw))
        tk = dict(kk=3, n_cols_valid=16 if gc else 24,
                  symmetric_problem=gc is None)
        got = pcc_topk_tiles(u, 1, 5, v_pad=vv, **kw, **tk)
        want = pcc_topk_tiles_plain(u.float(), 1, 5, v_pad=None if vv is None
                                    else vv.float(), **kw, **tk)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("rect", [False, True])
@pytest.mark.parametrize("l", [2, 9, 13])
def test_int16_kendall_bitwise_equal_reference(l, rect):
    x = _x(37, l, seed=26)
    y = _x(21, l, seed=27) if rect else None
    kw = dict(measure="kendall", t=8, l_blk=8, max_tiles_per_pass=4)
    got = corr(x, y, compute_dtype="int16", device="cpu", **kw)
    want = np.asarray(ref_corr(jnp.asarray(x),
                               None if y is None else jnp.asarray(y),
                               compute_dtype=jnp.int16, **kw))
    np.testing.assert_array_equal(got.numpy(), want)
    # bitwise the int8 run, whose kernels it runs
    assert torch.equal(got, corr(x, y, compute_dtype="int8", device="cpu",
                                 **kw))
    plan = ExecutionPlan.create(37, l, compute_dtype="int16", **kw)
    assert plan.compute_dtype == torch.int16
    assert plan.spec_dict() == RefPlan.create(
        37, l, compute_dtype=jnp.int16, **kw).spec_dict()
    u = plan.prepare(torch.from_numpy(x))
    assert u.dtype == torch.int16
    np.testing.assert_array_equal(u.numpy(), np.asarray(RefPlan.create(
        37, l, compute_dtype=jnp.int16, **kw).prepare(jnp.asarray(x))))


def test_int16_kendall_topk_and_significance_equal_int8():
    x = _x(30, 11, seed=28)
    kw = dict(measure="kendall", t=8, l_blk=8, max_tiles_per_pass=3,
              device="cpu")
    for sink in (TopKSink, DeviceTopKSink):
        got = corr(x, sink=sink(5), compute_dtype="int16", **kw)
        want = corr(x, sink=sink(5), compute_dtype="int8", **kw)
        np.testing.assert_array_equal(got["indices"], want["indices"])
        np.testing.assert_array_equal(got["values"], want["values"])
    from repro_torch.core.significance import PermutationSpec
    spec = PermutationSpec(6, key=3, chunk=4)
    r16, p16 = corr(x, pvalues=spec, compute_dtype="int16", **kw)
    r8, p8 = corr(x, pvalues=spec, compute_dtype="int8", **kw)
    assert torch.equal(r16, r8) and torch.equal(p16, p8)


@pytest.mark.parametrize("measure", ["pearson", "spearman", "cosine",
                                     "covariance", "dot", "kendall_tau_b"])
def test_int16_refused_off_exact_int8_by_both_packages(measure):
    """Off exact_int8 measures int16 needs a quantization scale neither
    package has: the reference fails with KeyError: 'int16' (quantize.QMAX)
    when it prepares, the port with a ValueError that names the missing
    scale when it plans."""
    x = _x(20, 9, seed=29)
    with pytest.raises(KeyError, match="int16"):
        ref_corr(jnp.asarray(x), measure=measure, t=8, l_blk=8,
                 compute_dtype=jnp.int16)
    with pytest.raises(ValueError, match="quantization scale"):
        corr(x, measure=measure, t=8, l_blk=8, compute_dtype="int16",
             device="cpu")
    with pytest.raises(ValueError, match="quantization scale"):
        ExecutionPlan.create(20, 9, measure=measure, compute_dtype=torch.int16)


# -- state conversion ----------------------------------------------------------


@pytest.mark.parametrize("measure,dtype", [("spearman", "bfloat16"),
                                           ("kendall", "int8"),
                                           ("kendall_tau_b", "bfloat16"),
                                           ("pearson", "float16"),
                                           ("kendall", "int16")])
@pytest.mark.parametrize("n_cols", [None, 21])
def test_convert_round_trips_narrow_plans_and_operands(measure, dtype,
                                                       n_cols):
    x, y = _x(37, 10, seed=14), _x(21, 10, seed=15)
    kw = dict(n_cols=n_cols, t=8, l_blk=8, measure=measure,
              compute_dtype=dtype, max_tiles_per_pass=5)
    ref_plan = RefPlan.create(37, 10, **kw)
    plan = convert.plan_from_reference(ref_plan.spec_dict())
    assert plan.spec_dict() == ref_plan.spec_dict()
    assert plan.compute_dtype == getattr(torch, dtype)
    if n_cols is None:
        ref_ops = (ref_plan.prepare(jnp.asarray(x)),)
    else:
        ref_ops = ref_plan.prepare_pair(jnp.asarray(x), jnp.asarray(y))
    ops = [convert.operand_from_reference(np.asarray(u), device="cpu")
           for u in ref_ops]
    for got, want in zip(ops, ref_ops):
        assert got.dtype == plan.compute_dtype
        np.testing.assert_array_equal(_bits16(_bits(got)),
                                      _bits16(_bits(want)))
    r = execute_plan(plan, *ops, device="cpu")
    want = ref_corr(jnp.asarray(x), None if n_cols is None else jnp.asarray(y),
                    **{k: v for k, v in kw.items() if k != "n_cols"})
    np.testing.assert_allclose(r.numpy(), np.asarray(want), rtol=0,
                               atol=BF16_ATOL)
