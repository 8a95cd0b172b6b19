"""The port's mesh (launch/mesh.py, ROADMAP A6) on the CPU: p > 1 plans
against the reference's, the one-process mesh executor, significance,
recovery and elastic re-meshing, ShardedHostSink ownership and serving
over a mesh.

A mesh of p ranks over ``torch.device("cpu")`` stands where the
reference's tests force a host device count.  The reference's own mesh
runs fail on this tree (ROADMAP C2), so the oracles are:
- the reference's plan functions at p > 1 (host numpy), value for value;
- the port's one-device run, which every mesh run must equal bitwise;
- the reference's single-device result (its design makes its mesh runs
  bitwise that), within 3e-6 (bf16 1e-5; indices, counts and the integer
  Kendall p-values equal).
Sizes stay at n <= 64, t = l_blk = 8.
"""

import dataclasses
import types
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.api import corr as ref_corr
from repro.core.plan import ExecutionPlan as RefPlan
from repro.core.significance import PermutationSpec as RefSpec
from repro.core.sinks import EdgeCountSink as RefEdgeCountSink
from repro.core.sinks import TopKSink as RefTopKSink
from repro.runtime import elastic as ref_elastic
from repro_torch.core import allpairs as ap
from repro_torch.core.allpairs import (assemble_from_stream, execute_plan,
                                       stream_tiles)
from repro_torch.core.api import corr
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.significance import PermutationSpec
from repro_torch.core.sinks import (DenseSink, DeviceTopKSink, EdgeCountSink,
                                    HostSink, ReductionSink, RowBlockSink,
                                    ShardedHostSink, TopKSink, assemble)
from repro_torch.launch.mesh import Mesh, describe, make_mesh
from repro_torch.runtime import elastic
from repro_torch.runtime.faults import (CrashFault, DeviceLostFault,
                                        FaultPlan, FaultSpec, RetryPolicy)
from repro_torch.serving import CorpusHandle, CorrServer, LiveIndex
from test_torch_significance import _ref_indices

T, LBLK = 8, 8
KW = dict(t=T, l_blk=LBLK, device="cpu")
ATOL = 3e-6
BF16_ATOL = 1e-5
N, L = 40, 20          # 5 row blocks: 15 triangle tiles
N_COLS = 29            # 4 column blocks: a 5 x 4 grid


def _x(n, l, seed=0):
    return np.random.default_rng(seed).normal(size=(n, l)).astype(np.float32)


def _mesh(kind: str) -> Mesh:
    if kind == "4":
        return make_mesh((4,), ("d",), devices=["cpu"] * 4)
    return make_mesh((2, 2), ("a", "b"), devices=["cpu"] * 4)


MESHES = ["4", "2x2"]


@pytest.fixture(scope="module")
def ref_runs():
    """The reference's single-device results, computed once per case."""
    cache = {}

    def get(key, fn):
        if key not in cache:
            cache[key] = fn()
        return cache[key]

    return get


def _same(a, b, label=""):
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, label
    assert np.array_equal(a.reshape(-1).view(np.uint8),
                          b.reshape(-1).view(np.uint8)), label


def _same_topk(a, b):
    _same(a["indices"], b["indices"])
    _same(a["values"], b["values"])


# -- plan parity at p > 1 ---------------------------------------------------------


def _plan_pair(workload, p, mtp):
    n_cols = None if workload == "triangle" else 40
    kw = dict(n_cols=n_cols, t=T, l_blk=LBLK, p=p, max_tiles_per_pass=mtp)
    return (ExecutionPlan.create(64, 12, **kw),
            RefPlan.create(64, 12, interpret=True, **kw))


@pytest.mark.parametrize("mtp", [None, 3])
@pytest.mark.parametrize("p", [1, 2, 3, 4, 8, 100])
@pytest.mark.parametrize("workload", ["triangle", "grid"])
def test_plan_parity_at_p(workload, p, mtp):
    """36 triangle tiles or a 8 x 5 grid of 40, at p up to past the tile
    count: every distribution function value for value."""
    plan, ref = _plan_pair(workload, p, mtp)
    assert plan.p == ref.p == p
    assert plan.per_dev == ref.per_dev
    assert plan.device_ranges == ref.device_ranges
    assert plan.launch_sizes == ref.launch_sizes
    assert plan.n_pass == ref.n_pass
    for k in range(plan.n_pass):
        assert plan.pass_offset(k) == ref.pass_offset(k)
        ids, sel = plan.pass_selection(k)
        rids, rsel = ref.pass_selection(k)
        np.testing.assert_array_equal(ids, rids)
        assert (sel is None) == (rsel is None)
        if sel is not None:
            np.testing.assert_array_equal(sel, rsel)
        np.testing.assert_array_equal(plan.pass_padded_ids(k),
                                      ref.pass_padded_ids(k))
        # each rank's launch is its valid slots of the pass
        got = np.concatenate([np.arange(s, s + c) for s, c in
                              plan.rank_slots(k)] + [np.empty(0, int)])
        np.testing.assert_array_equal(got, ids)
    for n_hosts in range(1, 9):
        if p % n_hosts == 0 or n_hosts == 1 or p == 1:
            for h in range(n_hosts):
                assert plan.host_tile_range(h, n_hosts) == \
                    ref.host_tile_range(h, n_hosts)
        else:
            for pl in (plan, ref):
                with pytest.raises(ValueError, match="must divide"):
                    pl.host_tile_range(0, n_hosts)
    for new_p in (1, 3, 7):
        assert plan.repartition(new_p).spec_dict() == \
            ref.repartition(new_p).spec_dict()
        assert plan.repartition(new_p).device_ranges == \
            ref.repartition(new_p).device_ranges
    assert plan.spec_dict() == ref.spec_dict()
    covered = np.zeros(plan.total_tiles, bool)
    covered[::3] = True
    assert plan.coverage_schedule(covered) == ref.coverage_schedule(covered)


def test_plan_rejects_bad_p():
    for bad in (0, -2):
        with pytest.raises(ValueError, match="p must be positive"):
            ExecutionPlan.create(16, 8, t=T, l_blk=LBLK, p=bad)
        with pytest.raises(ValueError, match="new_p must be positive"):
            ExecutionPlan.create(16, 8, t=T, l_blk=LBLK).repartition(bad)


# -- the mesh type -------------------------------------------------------------


def test_make_mesh_ranks_and_refusals():
    m = _mesh("2x2")
    assert m.axis_names == ("a", "b")
    assert list(m.shape.items()) == [("a", 2), ("b", 2)]
    assert m.size == 4 and m.ranks == (torch.device("cpu"),) * 4
    assert m.distinct_devices == (torch.device("cpu"),)
    assert describe(m) == "Mesh(a=2 x b=2; 4 ranks on cpu)"
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh((2, 2), ("a", "b"), devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="axis names"):
        Mesh(np.array(["cpu"] * 2, dtype=object), ("a", "b"))


def test_cuda_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh((2,), ("d",))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh((2,), ("d",), devices=["cuda:0", "cuda:0"])


def test_mesh_refusals():
    x = _x(N, L)
    m = _mesh("4")
    with pytest.raises(TypeError, match="Mesh"):
        corr(x, mesh=object(), **KW)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="disagrees with the mesh"):
            corr(x, mesh=m, t=T, l_blk=LBLK, device="cuda")
    plan = ExecutionPlan.create(N, L, t=T, l_blk=LBLK, p=4)
    u = plan.prepare(torch.from_numpy(x))
    with pytest.raises(ValueError, match="runs on a mesh"):
        execute_plan(plan, u, device="cpu")
    with pytest.raises(ValueError, match="does not match the mesh"):
        execute_plan(plan, u, device="cpu", mesh=_mesh_of(8))
    with pytest.raises(ValueError, match="does not compose with shard_u"):
        corr(x, mesh=m, shard_u=True, sink=DeviceTopKSink(3), **KW)
    with pytest.raises(ValueError, match="symmetric workload only"):
        corr(x, _x(N_COLS, L), mesh=m, shard_u=True, **KW)
    with pytest.raises(ValueError, match="shard_u is not supported with"):
        corr(x, where="nan", mesh=m, shard_u=True, **KW)


def _mesh_of(p):
    return make_mesh((p,), ("d",), devices=["cpu"] * p)


# -- the executor ----------------------------------------------------------------

MEASURES = {
    "pearson": (N, L), "spearman": (N, L), "cosine": (N, L),
    "covariance": (N, L), "kendall_merge": (24, 100),
}


@pytest.mark.parametrize("shard_u", [False, True])
@pytest.mark.parametrize("split", [None, 2])
@pytest.mark.parametrize("measure", list(MEASURES))
@pytest.mark.parametrize("kind", MESHES)
def test_mesh_corr_is_the_one_device_run(kind, measure, split, shard_u,
                                         ref_runs):
    n, l = MEASURES[measure]
    x = _x(n, l, seed=1)
    kw = dict(measure=measure, max_tiles_per_pass=split, **KW)
    got = corr(x, mesh=_mesh(kind), shard_u=shard_u, **kw)
    _same(got, corr(x, **kw), measure)
    want = ref_runs(("sym", measure), lambda: np.asarray(ref_corr(
        jnp.asarray(x), measure=measure, t=T, l_blk=LBLK)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("sink", ["dense", "topk", "device_topk"])
@pytest.mark.parametrize("kind", MESHES)
def test_mesh_grid_is_the_one_device_run(kind, sink, ref_runs):
    x, y = _x(N, L, seed=2), _x(N_COLS, L, seed=3)
    make = {"dense": lambda: None, "topk": lambda: TopKSink(5),
            "device_topk": lambda: DeviceTopKSink(5)}[sink]
    kw = dict(max_tiles_per_pass=3, **KW)
    got = corr(x, y, mesh=_mesh(kind), sink=make(), **kw)
    want_port = corr(x, y, sink=make(), **kw)
    if sink == "dense":
        _same(got, want_port)
        want = ref_runs(("grid",), lambda: np.asarray(ref_corr(
            jnp.asarray(x), jnp.asarray(y), t=T, l_blk=LBLK)))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
        return
    _same_topk(got, want_port)
    want = ref_runs(("grid_topk",), lambda: ref_corr(
        jnp.asarray(x), jnp.asarray(y), t=T, l_blk=LBLK,
        sink=RefTopKSink(5)))
    np.testing.assert_array_equal(got["indices"], want["indices"])
    np.testing.assert_allclose(got["values"], want["values"], rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("split", [None, 2])
@pytest.mark.parametrize("sink", [TopKSink, DeviceTopKSink])
@pytest.mark.parametrize("kind", MESHES)
def test_mesh_topk_is_the_one_device_run(kind, sink, split, ref_runs):
    x = _x(N, L, seed=4)
    kw = dict(max_tiles_per_pass=split, **KW)
    got = corr(x, mesh=_mesh(kind), sink=sink(5), **kw)
    _same_topk(got, corr(x, sink=sink(5), **kw))
    want = ref_runs(("topk",), lambda: ref_corr(
        jnp.asarray(x), t=T, l_blk=LBLK, sink=RefTopKSink(5)))
    np.testing.assert_array_equal(got["indices"], want["indices"])
    np.testing.assert_allclose(got["values"], want["values"], rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("measure,cd,l", [("kendall", "int8", 12),
                                          ("pearson", "bfloat16", L)])
@pytest.mark.parametrize("kind", MESHES)
def test_mesh_narrow_operands(kind, measure, cd, l, ref_runs):
    x = _x(N, l, seed=5)
    kw = dict(measure=measure, compute_dtype=cd, max_tiles_per_pass=2, **KW)
    for sink in (None, DeviceTopKSink):
        got = corr(x, mesh=_mesh(kind), sink=sink and sink(4), **kw)
        want = corr(x, sink=sink and sink(4), **kw)
        if sink is None:
            _same(got, want)
        else:
            _same_topk(got, want)
    got = corr(x, mesh=_mesh(kind), **kw)
    ref_cd = jnp.int8 if cd == "int8" else jnp.bfloat16
    want = ref_runs(("narrow", measure), lambda: np.asarray(ref_corr(
        jnp.asarray(x), measure=measure, compute_dtype=ref_cd, t=T,
        l_blk=LBLK)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=BF16_ATOL if cd == "bfloat16" else ATOL)


@pytest.mark.parametrize("kind", MESHES)
def test_mesh_masked_is_the_one_device_run(kind):
    x = _x(N, L, seed=6)
    x[3, :4] = np.nan
    x[17, 9] = np.nan
    kw = dict(where="nan", max_tiles_per_pass=2, **KW)
    _same(corr(x, mesh=_mesh(kind), **kw), corr(x, **kw))


@pytest.mark.parametrize("kind", MESHES)
def test_mesh_hostsink_stopped_and_resumed(kind, tmp_path):
    """HostSink(path=) over the mesh, crashed at its third commit and
    resumed with resume_from=: bitwise DenseSink, and the resume launches
    only the passes the sidecar lacks."""
    x = _x(N, L, seed=7)
    kw = dict(max_tiles_per_pass=1, **KW)
    m = _mesh(kind)
    path = str(tmp_path / "r.mm")
    with FaultPlan.single("sink_commit", "crash", at=3).armed(), \
            pytest.raises(CrashFault):
        corr(x, mesh=m, sink=HostSink(path=path), **kw)
    launched = []
    orig = ap.launch_tiles

    def spy(plan, u, j0, launch, v=None):
        launched.append(int(j0))
        return orig(plan, u, j0, launch, v=v)

    ap.launch_tiles = spy
    try:
        got = corr(x, mesh=m, resume_from=path, **kw)
    finally:
        ap.launch_tiles = orig
    _same(got, corr(x, **kw).numpy())
    plan = ExecutionPlan.create(N, L, t=T, l_blk=LBLK, p=4,
                                max_tiles_per_pass=1)
    # passes 0 and 1 were committed before the crash at the third commit
    # (the first commit is the empty sidecar at open)
    want = [s for k in range(1, plan.n_pass)
            for s, c in plan.rank_slots(k) if c]
    assert launched == want


@pytest.mark.parametrize("kind", MESHES)
def test_mesh_reduction_sinks(kind, ref_runs):
    x, y = _x(N, L, seed=8), _x(N_COLS, L, seed=9)
    m = _mesh(kind)
    labels = np.arange(N) % 3
    kw = dict(max_tiles_per_pass=2, **KW)
    got = corr(x, mesh=m, sink=EdgeCountSink(0.2, labels=labels), **kw)
    want = corr(x, sink=EdgeCountSink(0.2, labels=labels), **kw)
    ref = ref_runs(("edges",), lambda: ref_corr(
        jnp.asarray(x), t=T, l_blk=LBLK,
        sink=RefEdgeCountSink(0.2, labels=labels)))
    for key in ("edges", "intra_edges", "inter_edges"):
        assert got[key] == want[key] == ref[key]
    np.testing.assert_array_equal(got["degrees"], want["degrees"])
    np.testing.assert_array_equal(got["degrees"], ref["degrees"])

    def row_max(state, ids, tiles, ys, xs, plan):
        for tile, yb in zip(tiles, ys):
            np.maximum.at(state, np.arange(yb * T, yb * T + T),
                          np.abs(tile).max(axis=1))
        return state

    for mesh in (m, None):
        out = corr(x, mesh=mesh, sink=ReductionSink(
            row_max, lambda: np.zeros(N + T, np.float32)), **kw)
        if mesh is not None:
            got_max = out
    _same(got_max, out)
    bounds = [(0, 7), (7, 30), (30, N)]
    got = corr(x, y, mesh=m, sink=RowBlockSink(bounds), **kw)
    want = corr(x, y, sink=RowBlockSink(bounds), **kw)
    for a, b in zip(got, want):
        _same(a, b)


@pytest.mark.parametrize("shard_u", [False, True])
@pytest.mark.parametrize("kind", MESHES)
def test_mesh_stream_tiles_assembles(kind, shard_u):
    x = _x(N, L, seed=10)
    m = _mesh(kind)
    plan = ExecutionPlan.create(N, L, t=T, l_blk=LBLK, p=4,
                                max_tiles_per_pass=2)
    chunks = list(stream_tiles(x, mesh=m, shard_u=shard_u, t=T, l_blk=LBLK,
                               max_tiles_per_pass=2, device="cpu"))
    # one piece a rank with tiles, pass by pass
    want_ids = [np.arange(s, s + c) for k in range(plan.n_pass)
                for s, c in plan.rank_slots(k) if c]
    assert len(chunks) == len(want_ids)
    for (ids, tiles), w in zip(chunks, want_ids):
        np.testing.assert_array_equal(ids, w)
        assert tiles.shape == (len(w), T, T)
    r = assemble_from_stream(N, T, plan.m, iter(chunks))
    _same(r, corr(x, **KW).numpy())
    with pytest.raises(ValueError, match="does not match mesh size"):
        list(stream_tiles(x, mesh=m, plan=ExecutionPlan.create(
            N, L, t=T, l_blk=LBLK), device="cpu"))


@pytest.mark.parametrize("shard_u", [False, True])
@pytest.mark.parametrize("measure", ["pearson", "kendall"])
@pytest.mark.parametrize("kind", MESHES)
def test_mesh_significance(kind, measure, shard_u, ref_runs):
    """r and p bitwise the one-device run; against the reference's own
    index rows (24 permutations of key 3): r within 3e-6 and, for
    Kendall's integer pair counts, p equal."""
    l = 12 if measure == "kendall" else L
    x = _x(24, l, seed=11)
    idx = ref_runs(("idx", l), lambda: _ref_indices(3, "permute", l))
    spec = PermutationSpec(iterations=len(idx), indices=idx, chunk=7)
    kw = dict(measure=measure, max_tiles_per_pass=2, **KW)
    r, p = corr(x, mesh=_mesh(kind), shard_u=shard_u, pvalues=spec, **kw)
    r1, p1 = corr(x, pvalues=spec, **kw)
    _same(r, r1)
    _same(p, p1)
    _same(r, corr(x, **kw))
    r_ref, p_ref = ref_runs(("sig", measure), lambda: tuple(
        np.asarray(a) for a in ref_corr(
            jnp.asarray(x), measure=measure, t=T, l_blk=LBLK,
            pvalues=RefSpec(iterations=len(idx), key=3,
                            chunk=len(idx)))))
    np.testing.assert_allclose(r.numpy(), r_ref, rtol=0, atol=ATOL)
    if measure == "kendall":
        np.testing.assert_array_equal(p.numpy(), p_ref)


@pytest.mark.parametrize("kind", MESHES)
def test_mesh_significance_grid(kind):
    x, y = _x(N, L, seed=12), _x(N_COLS, L, seed=13)
    spec = PermutationSpec(iterations=16, key=4, chunk=6)
    kw = dict(max_tiles_per_pass=3, compute_dtype="int8", **KW)
    r, p = corr(x, y, mesh=_mesh(kind), pvalues=spec, **kw)
    r1, p1 = corr(x, y, pvalues=spec, **kw)
    _same(r, r1)
    _same(p, p1)


# -- memory bound ---------------------------------------------------------------


@pytest.mark.parametrize("p", [1, 4])
def test_significance_keeps_one_replica_stack_live(p, monkeypatch):
    """A significance run builds each chunk's replica stack after the last
    one is freed, and frees it once its launches are queued, before the
    comparisons' temporaries are made, over a mesh and on one device
    (mesh=None): one stack, the largest buffer of the run, is live at a
    time, and never beside those temporaries."""
    from repro_torch.core import significance as sig
    from repro_torch.core.significance import replica_operand, \
        run_significance

    x = torch.from_numpy(_x(40, 24, seed=16))
    spec = PermutationSpec(iterations=12, key=5, chunk=3)
    plan = ExecutionPlan.create(40, 24, t=T, l_blk=LBLK, p=p, replicas=12,
                                replica_chunk=3, max_tiles_per_pass=4)
    u = plan.prepare(x)
    stacks = []

    def source(ci, idx):
        assert all(ref() is None for ref in stacks), \
            f"chunk {ci}: an earlier replica stack is still alive"
        stack = replica_operand(plan, idx, method="permute", columns=x,
                                cols_prepared=u)
        stacks.append(weakref.ref(stack))
        return stack

    cmp_vals = sig._cmp_vals
    compares = []

    def spy(plan_, raw):
        compares.append(all(ref() is None for ref in stacks))
        return cmp_vals(plan_, raw)

    monkeypatch.setattr(sig, "_cmp_vals", spy)
    r, pv = run_significance(plan, spec, u, columns=x,
                             mesh=None if p == 1 else _mesh_of(p),
                             replica_source=source)
    assert len(stacks) == 4 * plan.n_pass
    # each rank's observed pass and each replica of each chunk
    assert len(compares) == sum(
        13 for k in range(plan.n_pass)
        for _, c in plan.rank_slots(k) if c) and all(compares)
    monkeypatch.undo()
    r1, p1 = corr(x, pvalues=spec, t=T, l_blk=LBLK, device="cpu")
    _same(r, r1)
    _same(pv, p1)


@pytest.mark.parametrize("p", [4, 8])
def test_mesh_pass_buffers_bounded(p, monkeypatch):
    """Every piece holds at most max_tiles_per_pass tiles of one rank, and
    while a sink consumes a piece at most two pass buffers per rank are
    alive (the double buffer): no pass is ever gathered on one device.
    The counterpart of tests/test_distributed.py's memory-bound test."""
    x = _x(96, 24, seed=14)
    mtp = 3
    plan = ExecutionPlan.create(96, 24, t=T, l_blk=LBLK, p=p,
                                max_tiles_per_pass=mtp)
    assert plan.n_pass > 2
    alive = []
    orig = ap.launch_tiles

    def spy(pl, u, j0, launch, v=None):
        buf = orig(pl, u, j0, launch, v=v)
        alive.append(weakref.ref(buf))
        return buf

    monkeypatch.setattr(ap, "launch_tiles", spy)

    class Probe(DenseSink):
        peak = 0
        pieces = 0

        def consume(self, ids, tiles, ready=None):
            assert tiles.shape[0] == len(ids) <= mtp
            live = sum(r() is not None for r in alive)
            Probe.peak = max(Probe.peak, live)
            Probe.pieces += 1
            super().consume(ids, tiles, ready)

    r = corr(x, mesh=_mesh_of(p), sink=Probe(), t=T, l_blk=LBLK,
             max_tiles_per_pass=mtp, device="cpu")
    assert Probe.pieces == sum(1 for k in range(plan.n_pass)
                               for _, c in plan.rank_slots(k) if c)
    assert 0 < Probe.peak <= 2 * p
    _same(r, corr(x, t=T, l_blk=LBLK, max_tiles_per_pass=mtp,
                  device="cpu"))


# -- recovery and elasticity ------------------------------------------------------


@pytest.mark.parametrize("sink", ["dense", "device_topk", "edges"])
def test_device_loss_shrinks_the_mesh(sink):
    """A device_loss at a pass launch of an 8-rank mesh: the default
    resolver drops a rank (8 -> 7), the run resumes from coverage and the
    result is bitwise the fault-free run.  The counterpart of
    tests/test_faults.py's 8-device shrink."""
    x = _x(64, 24, seed=15)
    make = {"dense": lambda: None, "device_topk": lambda: DeviceTopKSink(5),
            "edges": lambda: EdgeCountSink(0.1)}[sink]
    kw = dict(max_tiles_per_pass=2, **KW)
    base = corr(x, sink=make(), **kw)
    pol = RetryPolicy(sleep=lambda s: None)
    fp = FaultPlan.single("pass_launch", "device_loss", at=2)
    with fp.armed():
        got = corr(x, mesh=_mesh_of(8), sink=make(), recovery=pol, **kw)
    assert fp.fired == [("pass_launch", 2, "device_loss")]
    assert [(e["action"], e["p"]) for e in pol.log] == [("shrink_mesh", 7)]
    if sink == "dense":
        _same(got, base)
    else:
        for key in base:
            _same(got[key], base[key])


def test_two_device_losses_shrink_twice():
    x = _x(64, 24, seed=30)
    kw = dict(max_tiles_per_pass=2, **KW)
    pol = RetryPolicy(sleep=lambda s: None)
    with FaultPlan([FaultSpec("pass_launch", "device_loss", (2, 4))]).armed():
        got = corr(x, mesh=_mesh_of(8), recovery=pol, **kw)
    assert [e["p"] for e in pol.log if e["action"] == "shrink_mesh"] == [7, 6]
    _same(got, corr(x, **kw))


def test_device_loss_shrinks_to_one_device_then_propagates():
    """A 2-rank mesh shrinks to local launches (p 1); a second loss has no
    survivor and propagates."""
    x = _x(N, L, seed=16)
    kw = dict(max_tiles_per_pass=1, **KW)
    pol = RetryPolicy(sleep=lambda s: None)
    with FaultPlan.single("pass_launch", "device_loss", at=2).armed():
        got = corr(x, mesh=_mesh_of(2), recovery=pol, **kw)
    assert [(e["action"], e["p"]) for e in pol.log] == [("shrink_mesh", 1)]
    _same(got, corr(x, **kw))
    pol = RetryPolicy(sleep=lambda s: None)
    with FaultPlan([FaultSpec("pass_launch", "device_loss", (2, 3))]).armed(), \
            pytest.raises(DeviceLostFault):
        corr(x, mesh=_mesh_of(2), recovery=pol, **kw)


def test_two_hosts_over_eight_ranks_crash_and_resume(tmp_path):
    """ShardedHostSink over an 8-rank mesh, 2 hosts: host h owns its 4
    ranks' ranges; host 1 crashes at a manifest commit and resumes; the
    shards assemble bitwise DenseSink and their files are disjoint."""
    x = _x(64, 24, seed=17)
    plan = ExecutionPlan.create(64, 24, t=T, l_blk=LBLK, p=8,
                                max_tiles_per_pass=1)
    u = plan.prepare(torch.from_numpy(x))
    m = _mesh_of(8)
    base = corr(x, max_tiles_per_pass=1, **KW).numpy()
    d = str(tmp_path / "shards")
    pol = RetryPolicy(sleep=lambda s: None)
    with FaultPlan.single("pass_launch", "device_loss", at=2).armed():
        r0 = execute_plan(plan, u, sink=ShardedHostSink(d, host=0, n_hosts=2),
                          mesh=m, device="cpu", recovery=pol)
    assert r0["complete"] and r0["range"] == (0, plan.device_range(3)[1])
    with FaultPlan.single("sink_commit", "crash", at=3).armed(), \
            pytest.raises(CrashFault):
        execute_plan(plan, u, sink=ShardedHostSink(d, host=1, n_hosts=2),
                     mesh=m, device="cpu")
    r1 = execute_plan(plan, u, sink=ShardedHostSink(d, host=1, n_hosts=2,
                                                    resume=True),
                      mesh=m, device="cpu")
    assert r1["complete"]
    assert r1["range"] == (plan.device_range(4)[0], plan.total_tiles)
    _same(assemble(d), base)


def test_elastic_plans_match_the_reference():
    """elastic_pcc_plan / shrink_data_axis / replan_execution on the port's
    mesh equal the reference's on the same shapes (the reference reads
    only a mesh's axis names and shape)."""
    mesh = make_mesh((4, 2), ("data", "model"), devices=["cpu"] * 8)
    ref_mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                     devices=np.empty((4, 2), object))
    for n_failed in (1, 2, 3):
        got = elastic.shrink_data_axis(mesh, n_failed)
        want = ref_elastic.shrink_data_axis(ref_mesh, n_failed)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
    ep = ExecutionPlan.create(352, 16, t=8, p=8, max_tiles_per_pass=64)
    rep = RefPlan.create(352, 16, t=8, p=8, max_tiles_per_pass=64,
                         interpret=True)
    got = elastic.elastic_pcc_plan(mesh, n_failed=2, total_tiles=990,
                                   exec_plan=ep)
    want = ref_elastic.elastic_pcc_plan(ref_mesh, n_failed=2,
                                        total_tiles=990, exec_plan=rep)
    assert got.new_shape == want.new_shape == (3, 2)
    assert got.new_tile_ranges == want.new_tile_ranges
    assert got.new_exec_plan.spec_dict() == want.new_exec_plan.spec_dict()
    assert got.new_exec_plan.device_ranges == want.new_exec_plan.device_ranges
    assert elastic.host_shard_plan(ep, 4) == ref_elastic.host_shard_plan(
        rep, 4)
    built = elastic.build_mesh(got, devices=["cpu"] * 7)
    assert tuple(built.devices.shape) == (3, 2)
    assert built.axis_names == ("data", "model")
    with pytest.raises(RuntimeError, match="need 6 devices"):
        elastic.build_mesh(got, devices=["cpu"] * 5)
    with pytest.raises(RuntimeError, match="cannot re-mesh"):
        elastic.shrink_data_axis(mesh, 7)
    shrunk = elastic.shrink_mesh(mesh, 3)
    assert shrunk.axis_names == ("rank",) and shrunk.size == 5
    assert elastic.shrink_mesh(mesh, 7) is None
    with pytest.raises(RuntimeError, match="no survivors"):
        elastic.shrink_mesh(mesh, 8)


# -- serving -----------------------------------------------------------------------


def test_corr_server_over_a_mesh():
    """CorrServer over a 4-rank mesh: each answer bitwise standalone
    corr(..., mesh=) (and the one-device corr), host_occupancy one value a
    rank; a significance query bitwise corr(pvalues=, mesh=).  The
    counterpart of tests/test_distributed.py's mesh-backed server."""
    rng = np.random.default_rng(9)
    corpus = rng.normal(size=(48, 16)).astype(np.float32)
    probes = rng.normal(size=(5, 16)).astype(np.float32)
    m = _mesh("4")
    spec = PermutationSpec(iterations=8, key=0)
    with CorrServer(corpus, t=T, l_blk=LBLK, max_wait_s=0.0,
                    mesh=m) as srv:
        dense = srv.query(probes, timeout=30)
        topk = srv.query(probes, k=4, timeout=30)
        sig = srv.significance(probes, pvalues=spec)
        st = srv.stats()
    kw = dict(t=T, l_blk=LBLK, device="cpu")
    _same(dense.value, corr(probes, corpus, mesh=m, **kw).numpy())
    _same(dense.value, corr(probes, corpus, **kw).numpy())
    _same_topk(topk.value, corr(probes, corpus, mesh=m, sink=TopKSink(4),
                                **kw))
    r, p = corr(probes, corpus, mesh=m, pvalues=spec, **kw)
    _same(sig.value[0], r)
    _same(sig.value[1], p)
    ho = st["host_occupancy"]
    # 1 x 6 tiles over 4 ranks of 2: three full ranks, one idle
    assert ho == [1.0, 1.0, 1.0, 0.0]
    assert len(ho) == m.size
    with CorrServer(corpus, t=T, l_blk=LBLK, device="cpu") as srv:
        srv.query(probes, timeout=30)
        assert srv.stats()["host_occupancy"] is None


@pytest.mark.parametrize("k", [None, 4])
def test_live_index_over_a_mesh(k):
    rng = np.random.default_rng(10)
    corpus = rng.normal(size=(40, 16)).astype(np.float32)
    h = CorpusHandle(corpus, t=T, l_blk=LBLK, device="cpu")
    li = LiveIndex(h, k=k, mesh=_mesh("2x2"),
                   recovery=RetryPolicy(sleep=lambda s: None))
    li1 = LiveIndex(CorpusHandle(corpus, t=T, l_blk=LBLK, device="cpu"),
                    k=k)
    _same(li.result()["r"] if k is None else li.result()["values"],
          li1.result()["r"] if k is None else li1.result()["values"])
    h.append(rng.normal(size=(6, 16)).astype(np.float32))
    cold = corr(h.x, t=T, l_blk=LBLK, device="cpu",
                sink=None if k is None else TopKSink(k))
    res = li.result()
    if k is None:
        _same(res["r"], cold.numpy())
    else:
        _same(res["indices"], cold["indices"])
        _same(res["values"], cold["values"])
    li.close()
    li1.close()
