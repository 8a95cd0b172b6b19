"""Port parity of the rectangular X-vs-Y workload against ``repro``: the
grid bijection, the tile kernel's grid mode (plain version against the
Pallas kernel in interpret mode), rectangular plans, their conversion, and
dense ``corr(x, y)``.

Tolerance 3e-6 against the reference: its own Pearson parity bound
(tests/test_distributed.py); both compute in float32 in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mapping as ref_mapping
from repro.core.api import corr as ref_corr
from repro.core.plan import ExecutionPlan as RefPlan
from repro.kernels.pcc_tile import EpilogueSpec as RefEpilogue
from repro.kernels.pcc_tile import pcc_tiles as ref_pcc_tiles
from repro_torch import convert
from repro_torch.core import mapping
from repro_torch.core.allpairs import execute_plan
from repro_torch.core.api import PairwiseProblem, corr
from repro_torch.core.plan import ExecutionPlan
from repro_torch.kernels.pcc_tile import (EpilogueSpec, pcc_tiles,
                                          pcc_tiles_plain)

ATOL = 3e-6

# (n_rows, n_cols, l, t, l_blk, max_tiles_per_pass): neither count a
# multiple of t, several passes with a ragged last one
CASES = [
    (37, 21, 29, 8, 8, 4),       # 5 x 3 = 15 tiles = 3 x 4 + 3
    (20, 70, 45, 16, 32, 3),     # 2 x 5 = 10 tiles = 3 x 3 + 1
    (9, 9, 17, 8, 8, None),      # a square grid of distinct operands
]


def _xy(n, n_cols, l, seed=0):
    """Normal data with a zero row in x and a constant row in y."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, l)).astype(np.float32)
    y = rng.standard_normal((n_cols, l)).astype(np.float32)
    x[min(3, n - 1)] = 0.0
    y[n_cols - 2] = 1.5
    return x, y


def test_grid_mapping_equals_reference():
    for rows, cols in [(1, 1), (3, 7), (7, 3), (69, 250)]:
        ids = np.arange(rows * cols)
        ys, xs = mapping.grid_job_coord_batch(rows, cols, ids)
        rys, rxs = ref_mapping.grid_job_coord_batch(rows, cols, ids)
        np.testing.assert_array_equal(ys, rys)
        np.testing.assert_array_equal(xs, rxs)
        for j in (0, rows * cols - 1, (rows * cols) // 2):
            y, x = mapping.grid_job_coord(rows, cols, j)
            assert (y, x) == ref_mapping.grid_job_coord(rows, cols, j)
            assert mapping.grid_job_id(rows, cols, y, x) == j
        w = mapping.GridWorkload(rows, cols)
        rw = ref_mapping.GridWorkload(rows, cols)
        assert (w.job_count, w.grid_cols, w.needs_symmetrize) == \
            (rw.job_count, rw.grid_cols, rw.needs_symmetrize)
    assert mapping.TriangularWorkload(4).grid_cols is None
    with pytest.raises(ValueError):
        mapping.grid_job_coord_batch(3, 7, [21])
    with pytest.raises(ValueError):
        mapping.grid_job_id(3, 7, 3, 0)
    with pytest.raises(ValueError):
        mapping.grid_job_coord(3, 7, -1)


def _operands(n, n_cols, l, t, l_blk):
    x, y = _xy(n, n_cols, l)
    plan = RefPlan.create(n, l, n_cols=n_cols, t=t, l_blk=l_blk,
                          interpret=True)
    u, v = plan.prepare_pair(jnp.asarray(x), jnp.asarray(y))
    return np.array(u), np.array(v)


@pytest.mark.parametrize("epilogue", [None, (None, (-1.0, 1.0)),
                                      (7.0, (-0.05, 0.05))])
@pytest.mark.parametrize("n,n_cols,l,t,l_blk,j_start,pass_tiles", [
    (37, 21, 29, 8, 8, 0, 15),     # the whole grid
    (37, 21, 29, 8, 8, 12, 3),     # the ragged end
    (37, 21, 29, 8, 8, 13, 6),     # ids past the end clamp
    (20, 70, 45, 16, 32, 2, 7),    # several sample blocks
])
def test_grid_plain_matches_interpret_pallas(n, n_cols, l, t, l_blk,
                                             j_start, pass_tiles, epilogue):
    u, v = _operands(n, n_cols, l, t, l_blk)
    gc = v.shape[0] // t
    spec = ref_spec = None
    if epilogue is not None:
        spec, ref_spec = EpilogueSpec(*epilogue), RefEpilogue(*epilogue)
    got = pcc_tiles_plain(torch.from_numpy(u), j_start, t=t, l_blk=l_blk,
                          pass_tiles=pass_tiles, epilogue=spec,
                          v_pad=torch.from_numpy(v), grid_cols=gc)
    want = ref_pcc_tiles(jnp.asarray(u), j_start, t=t, l_blk=l_blk,
                         pass_tiles=pass_tiles, interpret=True,
                         epilogue=ref_spec, v_pad=jnp.asarray(v),
                         grid_cols=gc)
    assert tuple(got.shape) == (pass_tiles, t, t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    assert torch.equal(pcc_tiles(torch.from_numpy(u), j_start, t=t,
                                 l_blk=l_blk, pass_tiles=pass_tiles,
                                 epilogue=spec, v_pad=torch.from_numpy(v),
                                 grid_cols=gc), got)


def test_grid_tiles_check_their_operands():
    u = torch.zeros(40, 8)
    v = torch.zeros(24, 8)
    kw = dict(t=8, l_blk=8, pass_tiles=2)
    with pytest.raises(ValueError, match="grid_cols"):
        pcc_tiles(u, 0, v_pad=v, grid_cols=4, **kw)      # 24 rows = 3 tiles
    with pytest.raises(ValueError, match="grid_cols"):
        pcc_tiles(u, 0, v_pad=torch.zeros(24, 16), grid_cols=3, **kw)
    with pytest.raises(ValueError, match="float32"):
        pcc_tiles(u, 0, v_pad=v.double(), grid_cols=3, **kw)
    with pytest.raises(ValueError, match="2-D"):
        pcc_tiles(u, 0, v_pad=v[None, None], grid_cols=3, **kw)
    # a 3-D column operand is a replica stack (significance runs): one
    # replica of v gives v's tiles
    assert torch.equal(pcc_tiles(u, 0, v_pad=v[None], grid_cols=3, **kw)[0],
                       pcc_tiles(u, 0, v_pad=v, grid_cols=3, **kw))
    # a second operand on the triangle: U's exact shape and dtype only
    w = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (40, 8)).astype(np.float32))
    assert torch.equal(pcc_tiles(w, 0, v_pad=w.clone(), **kw),
                       pcc_tiles(w, 0, **kw))
    with pytest.raises(ValueError, match="matches u_pad exactly"):
        pcc_tiles(u, 0, v_pad=torch.zeros(48, 8), **kw)
    with pytest.raises(NotImplementedError, match="symmetric_grid"):
        pcc_tiles(u, 0, grid_cols=5, **kw)     # U against itself: not ported


@pytest.mark.parametrize("n,n_cols,l,t,l_blk,mtp", CASES)
def test_rectangular_corr_matches_reference(n, n_cols, l, t, l_blk, mtp):
    x, y = _xy(n, n_cols, l)
    r = corr(x, y, t=t, l_blk=l_blk, max_tiles_per_pass=mtp, device="cpu")
    want = np.asarray(ref_corr(jnp.asarray(x), jnp.asarray(y), t=t,
                               l_blk=l_blk, max_tiles_per_pass=mtp))
    assert r.shape == (n, n_cols) and r.dtype == torch.float32
    np.testing.assert_allclose(r.numpy(), want, rtol=0, atol=ATOL)
    assert not r[min(3, n - 1)].any() and not r[:, n_cols - 2].any()
    # the result does not depend on the pass split or the fusion, bit for bit
    for split in (1, 2, 10 ** 6):
        for fuse in (True, False):
            assert torch.equal(r, corr(x, y, t=t, l_blk=l_blk,
                                       max_tiles_per_pass=split,
                                       fuse_epilogue=fuse, device="cpu"))


def test_rectangular_corr_against_itself_equals_symmetric():
    x, _ = _xy(37, 21, 29)
    sym = corr(x, t=8, l_blk=8, device="cpu")
    rect = corr(x, x, t=8, l_blk=8, device="cpu")
    np.testing.assert_allclose(rect.numpy(), sym.numpy(), rtol=0, atol=ATOL)
    problem = PairwiseProblem.create(x, x[:5], device="cpu")
    assert not problem.symmetric and problem.n_cols == 5
    with pytest.raises(ValueError, match="y must be"):
        corr(x, x[:, :5], device="cpu")


@pytest.mark.parametrize("kw", [
    dict(), dict(t=16, l_blk=8), dict(max_tiles_per_pass=5),
    dict(max_tiles_per_pass=10 ** 6), dict(clip=False),
    dict(fuse_epilogue=False), dict(t=8, l_blk=64, max_tiles_per_pass=7),
])
def test_rectangular_spec_dict_equals_reference(kw):
    for n, n_cols, l in [(37, 21, 29), (1_639, 17_555, 5_072), (5, 300, 3)]:
        ours = ExecutionPlan.create(n, l, n_cols=n_cols, **kw)
        ref = RefPlan.create(n, l, n_cols=n_cols, **kw)
        assert ours.spec_dict() == ref.spec_dict()
        assert ours.spec_key() == ref.spec_key()
        assert ours.launch_sizes == ref.launch_sizes
        assert (ours.n_cols, ours.col_pad, ours.symmetric_problem) == (
            ref.n_cols, ref.col_pad, ref.symmetric_problem)


def test_prepare_pair_and_execute_plan_check_operands():
    x, y = _xy(37, 21, 29)
    plan = ExecutionPlan.create(37, 29, n_cols=21, t=8, l_blk=8)
    sym = ExecutionPlan.create(37, 29, t=8, l_blk=8)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    with pytest.raises(ValueError, match="rectangular"):
        sym.prepare_pair(tx, ty)
    with pytest.raises(ValueError, match="x shape"):
        plan.prepare_pair(tx[:5], ty)
    with pytest.raises(ValueError, match="y shape"):
        plan.prepare_pair(tx, ty[:5])
    u, v = plan.prepare_pair(tx, ty)
    assert tuple(u.shape) == (40, 32) and tuple(v.shape) == (24, 32)
    with pytest.raises(ValueError, match="needs v_pad"):
        execute_plan(plan, u, device="cpu")
    with pytest.raises(ValueError, match="one operand"):
        execute_plan(sym, u, v, device="cpu")
    with pytest.raises(ValueError, match="v_pad shape"):
        execute_plan(plan, u, v[:16], device="cpu")


def test_convert_round_trips_a_grid_plan():
    n, n_cols, l, t, l_blk, mtp = 37, 21, 29, 8, 8, 4
    x, y = _xy(n, n_cols, l, seed=2)
    ref_plan = RefPlan.create(n, l, n_cols=n_cols, t=t, l_blk=l_blk,
                              max_tiles_per_pass=mtp)
    ru, rv = ref_plan.prepare_pair(jnp.asarray(x), jnp.asarray(y))
    plan = convert.plan_from_reference(ref_plan.spec_dict())
    assert plan.spec_dict() == ref_plan.spec_dict()
    assert isinstance(plan.workload, mapping.GridWorkload)
    u = convert.operand_from_reference(np.asarray(ru), device="cpu")
    v = convert.operand_from_reference(np.asarray(rv), device="cpu")
    r = execute_plan(plan, u, v, device="cpu")
    np.testing.assert_allclose(
        r.numpy(), np.asarray(ref_corr(jnp.asarray(x), jnp.asarray(y), t=t,
                                       l_blk=l_blk, max_tiles_per_pass=mtp)),
        rtol=0, atol=ATOL)
    spec = ref_plan.spec_dict()
    with pytest.raises(ValueError):
        convert.plan_from_reference({**spec, "total_tiles": 1})
    with pytest.raises(NotImplementedError):
        convert.plan_from_reference({**spec, "workload": "BandWorkload"})
