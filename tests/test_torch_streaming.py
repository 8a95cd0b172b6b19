"""The port's streaming entry points (stream_tiles, assemble_from_stream),
its deprecated drivers, the planted-module data and the pcc oracles
against repro on the same seeded inputs, on the CPU.

Tiles within 3e-6 of the reference (its own Pearson parity bound,
tests/test_distributed.py), ids and pass boundaries equal; inside the port
the stream assembles to DenseSink's bits, and every deprecated wrapper
warns exactly once and gives corr()'s bits.  Data generators are numpy in
both packages, so their bytes are equal.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import allpairs as ref_ap
from repro.core import pcc as ref_pcc
from repro.data import expression as ref_expr
from repro_torch.core import allpairs as ap
from repro_torch.core import pcc
from repro_torch.core.allpairs import (allpairs_pcc, allpairs_pcc_streamed,
                                       allpairs_similarity,
                                       allpairs_similarity_streamed,
                                       assemble_from_stream, stream_tiles)
from repro_torch.core.api import corr
from repro_torch.core.plan import ExecutionPlan
from repro_torch.data import expression
from repro_torch.launch.mesh import make_mesh

ATOL = 3e-6
KW = dict(t=8, l_blk=8)


def _x(n, l, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, l)).astype(np.float32)


@pytest.mark.parametrize("measure,mtp", [("pearson", 4), ("pearson", None),
                                         ("spearman", 5),
                                         ("covariance", 3)])
def test_stream_tiles_matches_reference(measure, mtp):
    x = _x(37, 29, seed=1)
    got = list(stream_tiles(x, measure=measure, max_tiles_per_pass=mtp,
                            device="cpu", **KW))
    want = list(ref_ap.stream_tiles(jnp.asarray(x), measure=measure,
                                    max_tiles_per_pass=mtp, **KW))
    assert len(got) == len(want)
    for (gi, gt), (wi, wt) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        assert isinstance(gt, torch.Tensor) and gt.shape == (len(gi), 8, 8)
        wt = np.asarray(wt)
        np.testing.assert_allclose(gt.numpy(), wt, atol=ATOL)
    plan = ExecutionPlan.create(37, 29, measure=measure,
                                max_tiles_per_pass=mtp, **KW)
    n_seen = 0
    for ids, buf in got:
        assert buf.shape[0] <= plan.max_tiles_per_pass
        n_seen += len(ids)
    assert n_seen == plan.total_tiles


@pytest.mark.parametrize("measure,mtp", [("pearson", 4), ("covariance", 3),
                                         ("cosine", None)])
def test_assemble_from_stream_is_dense_sink(measure, mtp):
    x = _x(50, 30, seed=3)
    plan = ExecutionPlan.create(50, 30, measure=measure, **KW)
    dense = corr(x, measure=measure, max_tiles_per_pass=mtp, device="cpu",
                 **KW).numpy()
    got = assemble_from_stream(
        50, 8, plan.m, stream_tiles(x, measure=measure,
                                    max_tiles_per_pass=mtp, device="cpu",
                                    **KW), measure=measure)
    np.testing.assert_array_equal(got, dense)
    want = ref_ap.assemble_from_stream(
        50, 8, plan.m, ref_ap.stream_tiles(jnp.asarray(x), measure=measure,
                                           max_tiles_per_pass=mtp, **KW),
        measure=measure)
    np.testing.assert_allclose(got, want, atol=ATOL)
    # into a caller array, from host numpy tiles
    out = np.full((plan.n_pad, plan.n_pad), 7.0, np.float32)
    host = assemble_from_stream(
        50, 8, plan.m, ((i, t.numpy()) for i, t in stream_tiles(
            x, measure=measure, max_tiles_per_pass=mtp, device="cpu",
            **KW)), out=out, measure=measure)
    np.testing.assert_array_equal(host, dense)
    assert np.shares_memory(host, out)


def test_stream_tiles_rejects_conflicting_plan():
    x = _x(16, 8, seed=11)
    plan1 = ExecutionPlan.create(16, 8, **KW)
    with pytest.raises(ValueError, match="measure"):
        list(stream_tiles(x, measure="cosine", plan=plan1, device="cpu",
                          **KW))
    with pytest.raises(ValueError, match="conflicts with plan.t"):
        list(stream_tiles(x, t=16, plan=plan1, device="cpu"))
    with pytest.raises(ValueError, match="conflicts with plan.l_blk"):
        list(stream_tiles(x, l_blk=16, plan=plan1, device="cpu"))
    with pytest.raises(ValueError, match="symmetric plan"):
        list(stream_tiles(x, device="cpu",
                          plan=ExecutionPlan.create(16, 8, n_cols=9, **KW)))
    with pytest.raises(ValueError, match="does not match plan"):
        list(stream_tiles(_x(15, 8), plan=plan1, device="cpu"))
    # matching (or default) keywords are fine, and the plan's split is kept
    plan2 = ExecutionPlan.create(16, 8, max_tiles_per_pass=1, **KW)
    chunks = list(stream_tiles(x, measure="pcc", plan=plan2, device="cpu",
                               **KW))
    assert [len(i) for i, _ in chunks] == [1, 1, 1]
    # a mesh is a launch.mesh.Mesh; shard_u without one changes nothing
    # (as in the reference), and a 4-rank mesh streams each rank's piece
    with pytest.raises(TypeError, match="Mesh"):
        list(stream_tiles(x, device="cpu", mesh=object()))
    alone = list(stream_tiles(x, device="cpu", plan=plan2))
    for got, want in zip(list(stream_tiles(x, device="cpu", plan=plan2,
                                           shard_u=True)), alone):
        np.testing.assert_array_equal(got[0], want[0])
        assert torch.equal(got[1], want[1])
    mesh = make_mesh((4,), ("d",), devices=["cpu"] * 4)
    pieces = list(stream_tiles(x, device="cpu", mesh=mesh, shard_u=True,
                               t=8, l_blk=8))
    assert [len(i) for i, _ in pieces] == [1, 1, 1]
    assert torch.equal(torch.cat([t for _, t in pieces]),
                       torch.cat([t for _, t in alone]))


def _one_warning(fn):
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = fn()
    dep = [w for w in rec if issubclass(w.category, DeprecationWarning)]
    assert len(dep) == 1, [str(w.message) for w in rec]
    assert "corr(" in str(dep[0].message)
    assert dep[0].filename == __file__     # stacklevel=3: the caller
    return out


@pytest.mark.parametrize("driver", [allpairs_pcc, allpairs_similarity])
def test_deprecated_driver_warns_once_and_is_corr(driver):
    assert allpairs_similarity is allpairs_pcc
    x = _x(33, 17, seed=4)
    for kw in ({}, {"max_tiles_per_pass": 4, "measure": "spearman"},
               {"compute_dtype": "bfloat16"}):
        got = _one_warning(lambda: driver(x, device="cpu", **KW, **kw))
        assert torch.equal(got, corr(x, device="cpu", **KW, **kw))


@pytest.mark.parametrize("driver", [allpairs_pcc_streamed,
                                    allpairs_similarity_streamed])
def test_deprecated_streamed_driver(driver):
    assert allpairs_similarity_streamed is allpairs_pcc_streamed
    x = _x(29, 14, seed=9)
    chunks = _one_warning(lambda: list(driver(x, max_tiles_per_pass=4,
                                              device="cpu", **KW)))
    raw = list(stream_tiles(x, max_tiles_per_pass=4, device="cpu", **KW))
    assert len(chunks) == len(raw) == 3
    for (ci, ct), (ri, rt) in zip(chunks, raw):
        assert isinstance(ct, np.ndarray)
        np.testing.assert_array_equal(ci, ri)
        np.testing.assert_array_equal(ct, rt.numpy())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = list(ref_ap.allpairs_pcc_streamed(
            jnp.asarray(x), max_tiles_per_pass=4, **KW))
    for (ci, ct), (wi, wt) in zip(chunks, want):
        np.testing.assert_array_equal(ci, wi)
        np.testing.assert_allclose(ct, wt, atol=ATOL)
    plan = ExecutionPlan.create(29, 14, **KW)
    r = assemble_from_stream(29, 8, plan.m, iter(chunks))
    np.testing.assert_array_equal(r, corr(x, device="cpu", **KW).numpy())


def test_warn_deprecated_driver_points_at_the_caller():
    def wrapper():
        ap.warn_deprecated_driver("old_driver", "x")
    with pytest.warns(DeprecationWarning, match="old_driver is deprecated"
                      ) as rec:
        wrapper()
    assert len(rec) == 1 and rec[0].filename == __file__


@pytest.mark.parametrize("spec_kw", [
    dict(n=40, l=30, seed=1, planted_modules=5),
    dict(n=33, l=17, seed=4, planted_modules=3, module_strength=0.5),
    dict(n=20, l=12, seed=2)])
def test_coexpressed_and_row_shards_bytes(spec_kw):
    spec = expression.ExpressionSpec(**spec_kw)
    rspec = ref_expr.ExpressionSpec(**spec_kw)
    for dtype in (np.float32, np.float64):
        got = expression.coexpressed(spec, dtype=dtype)
        want = ref_expr.coexpressed(rspec, dtype=dtype)
        assert got.dtype == want.dtype
        assert got.tobytes() == want.tobytes()
    assert expression.artificial(spec).tobytes() == \
        ref_expr.artificial(rspec).tobytes()
    for planted in (False, True):
        got = list(expression.row_shards(spec, 7, planted=planted))
        want = list(ref_expr.row_shards(rspec, 7, planted=planted))
        assert [lo for lo, _ in got] == [lo for lo, _ in want]
        for (_, g), (_, w) in zip(got, want):
            assert g.tobytes() == w.tobytes()


def test_pcc_oracles_match_reference():
    for n, l in ((17_555, 5_072), (64_000, 5_000), (37, 29), (1, 1)):
        assert pcc.flops_allpairs(n, l) == ref_pcc.flops_allpairs(n, l)
    x = _x(12, 9, seed=5)
    u = pcc.transform(torch.from_numpy(x))
    np.testing.assert_allclose(
        pcc.pearson_from_u(u).numpy(),
        np.asarray(ref_pcc.pearson_from_u(ref_pcc.transform(
            jnp.asarray(x)))), atol=ATOL)
    xd = torch.from_numpy(x.astype(np.float64))
    for i, j in ((0, 1), (3, 7), (5, 5)):
        got = float(pcc.pearson_pair_literal(xd[i], xd[j]))
        want = float(np.corrcoef(x[i].astype(np.float64),
                                 x[j].astype(np.float64))[0, 1])
        assert got == pytest.approx(want, abs=1e-12)
        assert float(pcc.pearson_literal(xd)[i, j]) == pytest.approx(
            got, abs=1e-12)
    flat = torch.ones(6, dtype=torch.float64)
    assert float(pcc.pearson_pair_literal(flat, xd[0, :6])) == 0.0
