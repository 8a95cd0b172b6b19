"""The streaming reduction sinks of the port (EdgeCountSink, ReductionSink,
RowBlockSink, ExceedanceSink(iterations=)) against repro.core on the same
seeded inputs, on the CPU.

Counts are integers and must equal the reference's exactly: fed the same
numpy tiles through ``consume``, and end to end against the port's own
dense adjacency.  Values within 3e-6 of the reference (its own Pearson
parity bound, tests/test_distributed.py); inside the port, RowBlockSink's
rows are DenseSink's bits and ExceedanceSink(iterations=B) is the default's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.api import corr as ref_corr
from repro.core.plan import ExecutionPlan as RefPlan
from repro.core.sinks import DenseSink as RefDenseSink
from repro.core.sinks import EdgeCountSink as RefEdgeCountSink
from repro.core.sinks import ExceedanceSink as RefExceedanceSink
from repro.core.sinks import ReductionSink as RefReductionSink
from repro.core.sinks import RowBlockSink as RefRowBlockSink
from repro_torch.core.allpairs import stream_tiles
from repro_torch.core.api import corr
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.sinks import (DenseSink, EdgeCountSink, ExceedanceSink,
                                    HostSink, ReductionSink, RowBlockSink)

ATOL = 3e-6
# n = 37 rows at t = 8: 5 row blocks, 15 triangle tiles in passes of 4; a
# second operand of 21 rows: 15 grid tiles
N, N_COLS, L = 37, 21, 29
KW = dict(t=8, l_blk=8, max_tiles_per_pass=4)
CPU = torch.device("cpu")


def _x(n, l, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, l)).astype(np.float32)


def _nan_x(n, l, seed, frac=0.15):
    x = _x(n, l, seed)
    x[np.random.default_rng(seed + 100).random(x.shape) < frac] = np.nan
    return x


def _adjacency(r, thr):
    r = np.asarray(r)
    return (np.abs(r) >= np.float32(thr)) & ~np.eye(r.shape[0], dtype=bool)


def _port_tiles(x, **kw):
    """The port's (ids, numpy tiles) passes of a symmetric run."""
    return [(ids, buf.numpy())
            for ids, buf in stream_tiles(x, device="cpu", **{**KW, **kw})]


def _both_edge_sinks(n, l, thr, labels, passes):
    """EdgeCountSink of each package opened on the same geometry and fed
    the same numpy tiles through consume."""
    port = EdgeCountSink(thr, labels=labels)
    port.open(ExecutionPlan.create(n, l, **KW), CPU)
    ref = RefEdgeCountSink(thr, labels=labels)
    ref.open(RefPlan.create(n, l, **KW))
    for ids, tiles in passes:
        port.consume(ids, torch.from_numpy(tiles))
        ref.consume(ids, tiles)
    return port.result(), ref.result()


def _assert_same_counts(got, want):
    assert got["edges"] == want["edges"]
    assert got["degrees"].dtype == np.int64
    np.testing.assert_array_equal(got["degrees"], want["degrees"])
    assert set(got) == set(want)
    if "intra_edges" in want:
        assert got["intra_edges"] == want["intra_edges"]
        assert got["inter_edges"] == want["inter_edges"]
    assert all(isinstance(got[k], int) for k in got if k != "degrees")


# ---------------------------------------------------------------------------
# EdgeCountSink
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("labelled", [False, True])
@pytest.mark.parametrize("thr", [0.1, 0.35])
def test_edge_count_equals_reference_on_the_same_tiles(thr, labelled):
    x = _x(N, L, seed=1)
    labels = np.arange(N) % 5 if labelled else None
    got, want = _both_edge_sinks(N, L, thr, labels, _port_tiles(x))
    _assert_same_counts(got, want)
    assert got["edges"] > 0


@pytest.mark.parametrize("mtp", [None, 3])
def test_edge_count_end_to_end_equals_port_dense_adjacency(mtp):
    x = _x(34, 16, seed=7)
    n, thr = 34, 0.35
    dense = corr(x, t=8, l_blk=8, device="cpu").numpy()
    adj = _adjacency(dense, thr)
    labels = np.arange(n) % 5
    got = corr(x, t=8, l_blk=8, max_tiles_per_pass=mtp, device="cpu",
               sink=EdgeCountSink(thr, labels=labels))
    assert got["edges"] == int(adj.sum()) // 2
    np.testing.assert_array_equal(got["degrees"], adj.sum(1))
    same = np.equal.outer(labels, labels)
    assert got["intra_edges"] == int((adj & same).sum()) // 2
    assert got["inter_edges"] == got["edges"] - got["intra_edges"]
    want = ref_corr(jnp.asarray(x), t=8, l_blk=8, max_tiles_per_pass=mtp,
                    sink=RefEdgeCountSink(thr, labels=labels))
    _assert_same_counts(got, want)


def test_edge_count_threshold_at_a_tile_value():
    """A threshold equal to a float32 value of the tiles counts that value
    (>=), in both packages."""
    x = _x(N, L, seed=2)
    passes = _port_tiles(x)
    vals = np.abs(np.concatenate([t.ravel() for _, t in passes]))
    thr = float(np.sort(vals)[-40])          # an off-diagonal |r|
    got, want = _both_edge_sinks(N, L, thr, None, passes)
    _assert_same_counts(got, want)
    below, _ = _both_edge_sinks(
        N, L, float(np.nextafter(np.float32(thr), np.float32(2))), None,
        passes)
    assert got["edges"] > below["edges"]


def test_edge_count_threshold_float32_cannot_hold():
    """0.1000000020 rounds to float32(0.1): |r| == float32(0.1) is a hit in
    float32 (the packages' compare) and would not be in float64."""
    thr = 0.1000000020
    assert np.float32(thr) == np.float32(0.1) and \
        float(np.float32(0.1)) < thr
    plan = ExecutionPlan.create(20, 5, **KW)      # 3 row blocks, 6 tiles
    rng = np.random.default_rng(3)
    tiles = rng.uniform(-0.3, 0.3, (plan.total_tiles, 8, 8)) \
        .astype(np.float32)
    v = np.float32(0.1)
    up, down = np.nextafter(v, np.float32(1)), np.nextafter(v, np.float32(0))
    flat = tiles.reshape(-1)
    flat[::7] = v
    flat[1::11] = -v
    flat[2::13] = up
    flat[3::17] = down
    ids = np.arange(plan.total_tiles)
    passes = [(ids[:4], tiles[:4]), (ids[4:], tiles[4:])]
    got, want = _both_edge_sinks(20, 5, thr, np.arange(20) % 3, passes)
    _assert_same_counts(got, want)
    f64, _ = _both_edge_sinks(20, 5, float(up), np.arange(20) % 3, passes)
    assert got["edges"] > f64["edges"]


@pytest.mark.parametrize("labelled", [False, True])
def test_edge_count_masked_runs(labelled):
    """Masked symmetric runs ride the triangle; each unordered pair is
    counted once, as the port's masked dense adjacency and the reference's
    masked EdgeCountSink count it."""
    n, thr = 18, 0.4
    xm = _nan_x(n, 22, seed=41)
    labels = np.arange(n) % 4 if labelled else None
    dense = corr(xm, where="nan", t=8, l_blk=8, device="cpu").numpy()
    adj = _adjacency(dense, thr)
    got = corr(xm, where="nan", t=8, l_blk=8, max_tiles_per_pass=3,
               device="cpu", sink=EdgeCountSink(thr, labels=labels))
    assert got["edges"] == int(adj.sum()) // 2
    np.testing.assert_array_equal(got["degrees"], adj.sum(1))
    want = ref_corr(jnp.asarray(xm), where="nan", t=8, l_blk=8,
                    max_tiles_per_pass=3,
                    sink=RefEdgeCountSink(thr, labels=labels))
    _assert_same_counts(got, want)


def test_edge_count_refusals():
    x, y = _x(26, 14, seed=8), _x(17, 14, seed=9)
    with pytest.raises(ValueError, match="symmetric"):
        corr(x, y, t=8, l_blk=8, device="cpu", sink=EdgeCountSink(0.5))
    with pytest.raises(ValueError, match="labels"):
        corr(x, t=8, l_blk=8, device="cpu",
             sink=EdgeCountSink(0.5, labels=np.arange(25)))


# ---------------------------------------------------------------------------
# ReductionSink
# ---------------------------------------------------------------------------


def _row_max_fold(state, ids, tiles, ys, xs, plan):
    """Row-wise max of off-diagonal |r| (O(n) state), one numpy callback
    for both packages; mirrored tiles feed their columns' rows."""
    t, n = plan.t, plan.n
    span = np.arange(t)
    for v, rb, cb in ((tiles, ys, xs),
                      (np.transpose(tiles, (0, 2, 1)), xs, ys)):
        rows = (rb[:, None] * t + span)[:, :, None]
        cols = (cb[:, None] * t + span)[:, None, :]
        ok = (rows < n) & (cols < n) & (rows != cols)
        a = np.where(ok, np.abs(v), -np.inf)
        r = np.broadcast_to(rows, a.shape)
        np.maximum.at(state, np.minimum(r, n - 1)[ok], a[ok])
    return state


def test_reduction_sink_one_callback_both_packages():
    x = _x(N, L, seed=4)
    init = np.full(N, -np.inf, np.float32)
    got = corr(x, device="cpu", sink=ReductionSink(_row_max_fold, init),
               **KW)
    want = ref_corr(jnp.asarray(x), sink=RefReductionSink(_row_max_fold,
                                                          init), **KW)
    np.testing.assert_allclose(got, want, atol=ATOL)
    dense = np.abs(corr(x, device="cpu", **KW).numpy())
    np.fill_diagonal(dense, -np.inf)
    np.testing.assert_array_equal(got, dense.max(1))
    # fed the same tiles, the states are equal exactly
    port = ReductionSink(_row_max_fold, init)
    port.open(ExecutionPlan.create(N, L, **KW), CPU)
    ref = RefReductionSink(_row_max_fold, init)
    ref.open(RefPlan.create(N, L, **KW))
    for ids, tiles in _port_tiles(x):
        port.consume(ids, torch.from_numpy(tiles))
        ref.consume(ids, tiles)
    np.testing.assert_array_equal(port.result(), ref.result())


def test_reduction_sink_reuse_does_not_leak_state():
    """A reused sink restarts from init even when the fold mutates state in
    place; a callable init is invoked per run."""
    x = _x(17, 9, seed=13)

    def fold(state, ids, tiles, ys, xs, plan):
        state += tiles.shape[0]  # in-place mutation of the state array
        return state

    snk = ReductionSink(fold, np.zeros(1))
    first = float(corr(x, t=8, l_blk=8, device="cpu", sink=snk)[0])
    second = float(corr(x, t=8, l_blk=8, device="cpu", sink=snk)[0])
    assert first == second == 6      # 3 row blocks: 6 triangle tiles
    calls = []
    snk2 = ReductionSink(lambda s, *a: s + 1, lambda: calls.append(1) or 0)
    corr(x, t=8, l_blk=8, device="cpu", sink=snk2)
    assert corr(x, t=8, l_blk=8, device="cpu", sink=snk2) == 1
    assert len(calls) == 2


# ---------------------------------------------------------------------------
# RowBlockSink
# ---------------------------------------------------------------------------


BOUNDS = [(0, 5), (5, 20), (20, 21), (21, 37), (3, 11)]


@pytest.mark.parametrize("mtp", [None, 4])
@pytest.mark.parametrize("measure", ["pearson", "covariance"])
def test_row_block_sink_is_dense_rows(mtp, measure):
    """Ragged ranges that straddle tile edges (and overlap) hold DenseSink's
    rows bit for bit, and the reference's RowBlockSink's within 3e-6."""
    x, y = _x(N, L, seed=5), _x(N_COLS, L, seed=6)
    kw = dict(t=8, l_blk=8, max_tiles_per_pass=mtp, measure=measure)
    dense = corr(x, y, device="cpu", **kw).numpy()
    got = corr(x, y, device="cpu", sink=RowBlockSink(BOUNDS), **kw)
    want = ref_corr(jnp.asarray(x), jnp.asarray(y),
                    sink=RefRowBlockSink(BOUNDS), **kw)
    assert len(got) == len(BOUNDS)
    for (lo, hi), g, w in zip(BOUNDS, got, want):
        assert g.shape == (hi - lo, N_COLS) and g.dtype == np.float32
        np.testing.assert_array_equal(g, dense[lo:hi])
        np.testing.assert_allclose(g, w, atol=ATOL)


def test_row_block_sink_unfused_clips_as_dense():
    x, y = _x(N, L, seed=7), _x(N_COLS, L, seed=8)
    kw = dict(t=8, l_blk=8, max_tiles_per_pass=4, fuse_epilogue=False)
    dense = corr(x, y, device="cpu", **kw).numpy()
    got = corr(x, y, device="cpu", sink=RowBlockSink([(2, 30)]), **kw)
    np.testing.assert_array_equal(got[0], dense[2:30])


def test_row_block_sink_refusals():
    x, y = _x(N, L, seed=9), _x(N_COLS, L, seed=10)
    with pytest.raises(ValueError, match="grid workloads"):
        corr(x, t=8, l_blk=8, device="cpu", sink=RowBlockSink([(0, 4)]))
    with pytest.raises(ValueError, match="exceeds plan rows"):
        corr(x, y, t=8, l_blk=8, device="cpu", sink=RowBlockSink([(0, 38)]))
    for bad in ([(-1, 3)], [(5, 4)]):
        with pytest.raises(ValueError, match="bad row range"):
            RowBlockSink(bad)


# ---------------------------------------------------------------------------
# ExceedanceSink(iterations=)
# ---------------------------------------------------------------------------


def _count_passes(plan, seed=11, b=40):
    rng = np.random.default_rng(seed)
    return [(plan.pass_ids(k),
             rng.integers(0, b + 1, (n, plan.t, plan.t)).astype(np.int32))
            for k, n in enumerate(plan.launch_sizes)]


def _exceedance(sink, plan, passes):
    sink.open(plan, CPU)
    for ids, counts in passes:
        sink.consume(ids, torch.from_numpy(counts))
        sink.pass_complete(0)
    return sink.result()


@pytest.mark.parametrize("n_cols", [None, N_COLS])
def test_exceedance_iterations_equals_default(n_cols):
    b = 40
    plan = ExecutionPlan.create(N, L, n_cols=n_cols, replicas=b, **KW)
    passes = _count_passes(plan, b=b)
    default = _exceedance(ExceedanceSink(), plan, passes)
    given = _exceedance(ExceedanceSink(iterations=b), plan, passes)
    assert torch.equal(default, given)
    # the reference's, fed the same counts: the same float32 operations
    ref = RefExceedanceSink(RefDenseSink(), iterations=b)
    ref.open(RefPlan.create(N, L, n_cols=n_cols, replicas=b, **KW))
    for ids, counts in passes:
        ref.consume(ids, counts)
    np.testing.assert_array_equal(default.numpy(), np.asarray(ref.result()))
    # iterations= also opens a plain plan, and overrides plan.replicas
    plain = ExecutionPlan.create(N, L, n_cols=n_cols, **KW)
    p = _exceedance(ExceedanceSink(iterations=b), plain, passes)
    assert torch.equal(p, default)
    other = _exceedance(ExceedanceSink(iterations=2 * b), plan, passes)
    assert not torch.equal(other, default)


def test_exceedance_refuses_no_replicas():
    plan = ExecutionPlan.create(N, L, **KW)
    for sink in (ExceedanceSink(), ExceedanceSink(iterations=0),
                 ExceedanceSink(iterations=-3)):
        with pytest.raises(ValueError, match="replica count"):
            sink.open(plan, CPU)


def test_exceedance_covered_passes_through():
    plan = ExecutionPlan.create(N, L, replicas=8, **KW)
    snk = ExceedanceSink(HostSink(), iterations=8)
    snk.open(plan, CPU)
    assert snk.covered().shape == (plan.total_tiles,)
    assert not snk.covered().any()
    snk.consume(plan.pass_ids(0), torch.zeros((4, 8, 8), dtype=torch.int32))
    snk.pass_complete(0)
    np.testing.assert_array_equal(np.nonzero(snk.covered())[0],
                                  plan.pass_ids(0))
    dense = ExceedanceSink(DenseSink(), iterations=8)
    dense.open(plan, CPU)
    assert dense.covered() is None
