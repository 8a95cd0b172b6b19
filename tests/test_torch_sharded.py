"""ShardedHostSink / ShardedMatrix / open_manifest / assemble and the
one-device distribution helpers of the port against the reference, case
for case with the p = 1 tests of tests/test_sharded.py, on the CPU.

Hosts are simulated in one process, as the reference's tests do: the same
plan runs once per host rank, and a host's ownership is a pure function of
(plan, host, n_hosts).  Inside the port, an assembled matrix is bitwise
DenseSink's; across the packages, shards written by either are resumed and
assembled by the other (the file names, JSON keys and CRCs are shared), and
values agree within 3e-6 (the reference's own Pearson parity bound).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tiling as ref_tiling
from repro.core.allpairs import execute_plan as ref_execute
from repro.core.plan import ExecutionPlan as RefPlan
from repro.core.sinks import DenseSink as RefDenseSink
from repro.core.sinks import ShardedHostSink as RefShardedHostSink
from repro.core.sinks import TopKSink as RefTopKSink
from repro.core.sinks import assemble as ref_assemble
from repro.core.sinks import open_manifest as ref_open_manifest
from repro.runtime import elastic as ref_elastic
from repro.runtime import faults as ref_faults
from repro_torch.core import allpairs as ap
from repro_torch.core import tiling
from repro_torch.core.allpairs import execute_plan
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.sinks import (DenseSink, DeviceTopKSink,
                                    ShardedHostSink, TopKSink, assemble,
                                    open_manifest)
from repro_torch.runtime import elastic, faults
from repro_torch.runtime.faults import FaultPlan, FaultSpec, RetryPolicy

ATOL = 3e-6
KW = dict(t=8, l_blk=8, max_tiles_per_pass=4)


def _x(n, l, seed=0):
    return np.random.default_rng(seed).normal(size=(n, l)).astype(np.float32)


def _plans_u(n, l=16, seed=0, n_cols=None, **kw):
    """The port's and the reference's plan and prepared operands."""
    kw = {**KW, **kw}
    plan = ExecutionPlan.create(n, l, n_cols=n_cols, **kw)
    ref = RefPlan.create(n, l, n_cols=n_cols, interpret=True, **kw)
    x = _x(n, l, seed)
    if n_cols is None:
        return (plan, (plan.prepare(torch.from_numpy(x)),),
                ref, (ref.prepare(jnp.asarray(x)),))
    y = _x(n_cols, l, seed + 1)
    return (plan, plan.prepare_pair(torch.from_numpy(x), torch.from_numpy(y)),
            ref, ref.prepare_pair(jnp.asarray(x), jnp.asarray(y)))


def _write(plan, ops, d, host, n_hosts, *, port=True, resume=False,
           **kw):
    """One host's shard, written by the port or the reference."""
    if port:
        return execute_plan(plan, *ops, device="cpu", sink=ShardedHostSink(
            d, host=host, n_hosts=n_hosts, resume=resume), **kw)
    return ref_execute(plan, *ops, sink=RefShardedHostSink(
        d, host=host, n_hosts=n_hosts, resume=resume), **kw)


def _dense(plan, ops):
    return execute_plan(plan, *ops, device="cpu", sink=DenseSink()).numpy()


def _chunk_files(d, host):
    with open(os.path.join(d, f"manifest.h{host}.json")) as f:
        return [c["file"] for c in json.load(f)["chunks"]]


class _Spy:
    """The tile starts the port's executor launches."""

    def __init__(self, monkeypatch):
        self.starts = []
        real = ap.pcc_tiles

        def spy(u, j0, **k):
            self.starts.append(int(j0))
            return real(u, j0, **k)

        monkeypatch.setattr(ap, "pcc_tiles", spy)


# -- round trips over pass-boundary residues ------------------------------------------

# n = 40 / 48 / 56 at t = 8: 15 / 21 / 28 tiles, residues mod 4 of 3, 1, 0
@pytest.mark.parametrize("n", [40, 48, 56])
@pytest.mark.parametrize("n_hosts", [1, 2, 3])
def test_sharded_roundtrip_matches_dense(tmp_path, n, n_hosts):
    """The port's shards assemble bitwise its DenseSink, in both packages'
    readers; shards of alternating writers (even hosts the port, odd the
    reference) assemble in both to the same bits, within ATOL of both
    packages' dense results."""
    plan, ops, ref, ref_ops = _plans_u(n, seed=n)
    want = _dense(plan, ops)
    d = str(tmp_path / "port")
    for h in range(n_hosts):
        assert _write(plan, ops, d, h, n_hosts)["complete"], h
    for read in (assemble, ref_assemble):
        np.testing.assert_array_equal(read(d), want)
    lo, hi = 7, min(19, n)
    np.testing.assert_array_equal(open_manifest(d).rows(lo, hi), want[lo:hi])
    np.testing.assert_array_equal(ref_open_manifest(d).rows(lo, hi),
                                  want[lo:hi])
    mixed = str(tmp_path / "mixed")
    for h in range(n_hosts):
        port = h % 2 == 0
        r = _write(plan if port else ref, ops if port else ref_ops, mixed, h,
                   n_hosts, port=port)
        assert r["complete"] and tuple(r["range"]) == \
            plan.host_tile_range(h, n_hosts)
    got = assemble(mixed)
    np.testing.assert_array_equal(got, ref_assemble(mixed))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(
        got, np.asarray(ref_execute(ref, *ref_ops, sink=RefDenseSink())),
        rtol=0, atol=ATOL)


def test_sharded_grid_roundtrip(tmp_path):
    plan, ops, ref, ref_ops = _plans_u(24, n_cols=40, seed=1)
    want = _dense(plan, ops)
    d = str(tmp_path)
    for h in range(2):
        assert _write(plan, ops, d, h, 2)["complete"]
    np.testing.assert_array_equal(assemble(d), want)
    np.testing.assert_array_equal(ref_assemble(d), want)
    np.testing.assert_array_equal(open_manifest(d).rows(3, 17), want[3:17])
    np.testing.assert_allclose(
        want, np.asarray(ref_execute(ref, *ref_ops, sink=RefDenseSink())),
        rtol=0, atol=ATOL)


def test_host_ranges_partition_total():
    plan, _, ref, _ = _plans_u(56)
    for n_hosts in (1, 2, 3, 5):
        ranges = elastic.host_shard_plan(plan, n_hosts)
        assert ranges == ref_elastic.host_shard_plan(ref, n_hosts)
        assert ranges[0][0] == 0 and ranges[-1][1] == plan.total_tiles
        for (_, hi), (lo, _) in zip(ranges, ranges[1:]):
            assert hi == lo          # contiguous, disjoint
    with pytest.raises(ValueError, match="out of range"):
        plan.host_tile_range(2, 2)
    with pytest.raises(ValueError, match="positive"):
        elastic.host_shard_plan(plan, 0)


@pytest.mark.parametrize("n,n_cols", [(1, None), (17, None), (40, None),
                                      (100, None), (9, 33), (64, 17)])
@pytest.mark.parametrize("mtp", [None, 1, 3, 7])
def test_distribution_helpers_match_reference(n, n_cols, mtp):
    """pass_selection, host_tile_range, tiles_per_device, balanced_counts,
    strided_ids, replan_pcc and host_shard_plan against the reference over
    a grid of sizes."""
    kw = dict(n_cols=n_cols, t=8, l_blk=8, max_tiles_per_pass=mtp)
    plan = ExecutionPlan.create(n, 5, **kw)
    ref = RefPlan.create(n, 5, interpret=True, **kw)
    assert plan.n_pass == ref.n_pass
    for k in range(plan.n_pass):
        ids, sel = plan.pass_selection(k)
        ref_ids, ref_sel = ref.pass_selection(k)
        assert sel is None and ref_sel is None
        np.testing.assert_array_equal(ids, ref_ids)
    total = plan.total_tiles
    for n_hosts in (1, 2, 3, 4, 7, 13):
        for h in range(n_hosts):
            assert plan.host_tile_range(h, n_hosts) == \
                ref.host_tile_range(h, n_hosts)
        assert elastic.host_shard_plan(plan, n_hosts) == \
            ref_elastic.host_shard_plan(ref, n_hosts)
        assert elastic.replan_pcc(total, n_hosts) == \
            ref_elastic.replan_pcc(total, n_hosts)
        assert tiling.balanced_counts(total, n_hosts) == \
            ref_tiling.balanced_counts(total, n_hosts)
        for i in range(n_hosts):
            assert tiling.strided_ids(total, n_hosts, i) == \
                ref_tiling.strided_ids(total, n_hosts, i)
    with pytest.raises(ValueError, match="positive"):
        tiling.balanced_counts(total, 0)


# -- manifest integrity: corruption, incompleteness, resume ---------------------------


@pytest.mark.parametrize("fixer", ["port", "reference"])
def test_corrupt_chunk_refused_then_recomputed_alone(tmp_path, monkeypatch,
                                                     fixer):
    """A flipped byte in one chunk of the port's shard is refused by both
    readers, naming the file; a resume by either package drops exactly that
    chunk and recomputes it alone, every other chunk file untouched."""
    plan, ops, ref, ref_ops = _plans_u(56, seed=3)
    want = _dense(plan, ops)
    d = str(tmp_path)
    for h in range(2):
        _write(plan, ops, d, h, 2)
    victim = os.path.join(d, _chunk_files(d, 0)[1])
    raw = bytearray(open(victim, "rb").read())
    raw[-3] ^= 0xFF
    open(victim, "wb").write(bytes(raw))
    for read in (assemble, ref_assemble):
        with pytest.raises(ValueError, match=os.path.basename(victim)):
            read(d)
    other = {f: open(os.path.join(d, f), "rb").read()
             for f in _chunk_files(d, 0) + _chunk_files(d, 1)
             if os.path.join(d, f) != victim}
    snk = ShardedHostSink(d, host=0, n_hosts=2, resume=True)
    snk.open(plan, torch.device("cpu"))
    missing = np.where(~snk.covered())[0]
    np.testing.assert_array_equal(missing, plan.pass_ids(1))
    spy = _Spy(monkeypatch)
    port = fixer == "port"
    r = _write(plan if port else ref, ops if port else ref_ops, d, 0, 2,
               port=port, resume=True)
    assert r["complete"]
    assert spy.starts == ([plan.pass_offset(1)] if port else [])
    got = assemble(d)
    np.testing.assert_array_equal(got, ref_assemble(d))
    if port:
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    for f, data in other.items():
        assert open(os.path.join(d, f), "rb").read() == data, f


def test_incomplete_assemble_names_missing_tiles(tmp_path):
    plan, ops, _, _ = _plans_u(48, seed=4)
    d = str(tmp_path)
    _write(plan, ops, d, 0, 2)
    for read in (assemble, ref_assemble):
        with pytest.raises(ValueError, match="missing"):
            read(d)
    # ... but the rows the written shard covers are readable
    want = _dense(plan, ops)
    np.testing.assert_array_equal(open_manifest(d).rows(0, 8), want[:8])
    np.testing.assert_array_equal(ref_open_manifest(d).rows(0, 8), want[:8])


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_crash_before_manifest_commit_then_resume(tmp_path, monkeypatch,
                                                  writer):
    """A shard crashed before its manifest commit by one package resumes in
    the other, which launches only the passes the manifest lacks; the
    crash fires on pass 0's commit in either package."""
    plan, ops, ref, ref_ops = _plans_u(56, seed=5)
    want = _dense(plan, ops)
    d = str(tmp_path)
    port = writer == "port"
    mod = faults if port else ref_faults
    fp = mod.FaultPlan.single("sink_commit", "crash", at=2)
    with pytest.raises(mod.CrashFault):
        with fp.armed():
            _write(plan if port else ref, ops if port else ref_ops, d, 0, 1,
                   port=port)
    assert fp.fired == [("sink_commit", 2, "crash")]  # pass 0's commit
    spy = _Spy(monkeypatch)
    r = _write(ref if port else plan, ref_ops if port else ops, d, 0, 1,
               port=not port, resume=True)
    assert r["complete"]
    if port:   # the reference resumed: no port launch
        assert spy.starts == []
    else:
        assert spy.starts == [plan.pass_offset(k)
                              for k in range(plan.n_pass)]
    np.testing.assert_allclose(assemble(d), want, rtol=0, atol=ATOL)


def test_resume_of_complete_shard_runs_no_passes(tmp_path):
    plan, ops, ref, ref_ops = _plans_u(48, seed=6)
    d = str(tmp_path)
    for h in range(2):
        _write(plan, ops, d, h, 2)
    cpu = torch.device("cpu")
    snk = ShardedHostSink(d, host=1, n_hosts=2, resume=True)
    snk.open(plan, cpu)
    assert bool(snk.covered().all())
    assert snk.resume_pass() == plan.n_pass   # nothing left to launch
    # a different pass split changes no bit of the output: resume takes it
    resplit = ExecutionPlan.create(48, 16, t=8, l_blk=8, max_tiles_per_pass=2)
    snk2 = ShardedHostSink(d, host=1, n_hosts=2, resume=True)
    snk2.open(resplit, cpu)
    assert bool(snk2.covered().all())
    ref_snk = RefShardedHostSink(d, host=1, n_hosts=2, resume=True)
    ref_snk.open(ref)
    assert bool(ref_snk.covered().all())
    # ... but a change of content is refused
    other = ExecutionPlan.create(48, 16, t=8, l_blk=16, max_tiles_per_pass=4)
    with pytest.raises(ValueError, match="spec"):
        ShardedHostSink(d, host=1, n_hosts=2, resume=True).open(other, cpu)
    with pytest.raises(ValueError, match="belongs"):
        ShardedHostSink(d, host=1, n_hosts=3, resume=True).open(plan, cpu)


# -- recovery composes ------------------------------------------------------------------


def test_sharded_sink_under_recovery_keeps_ownership(tmp_path):
    """Faults at every site of the sink and an out-of-memory re-split: the
    frozen range survives rebind, the chunks hold every owned tile once,
    and the shards assemble bitwise DenseSink; the reference under the
    same plan fires the same faults and writes the same log."""
    plan, ops, ref, ref_ops = _plans_u(56, seed=7)
    want = _dense(plan, ops)
    specs = [("pass_launch", "oom", (2,)),
             ("sink_write", "partial_write", (3,), 0.5),
             ("sink_flush", "io", (4,))]
    for h in range(2):
        fp = FaultPlan([FaultSpec(*s) for s in specs])
        ref_fp = ref_faults.FaultPlan([ref_faults.FaultSpec(*s)
                                       for s in specs])
        pol = RetryPolicy(sleep=lambda s: None)
        ref_pol = ref_faults.RetryPolicy(sleep=lambda s: None)
        with fp.armed():
            r = _write(plan, ops, str(tmp_path / "p"), h, 2, recovery=pol)
        with ref_fp.armed():
            _write(ref, ref_ops, str(tmp_path / "r"), h, 2, port=False,
                   recovery=ref_pol)
        assert fp.fired == ref_fp.fired and pol.log == ref_pol.log
        assert r["complete"] and r["range"] == plan.host_tile_range(h, 2)
        with open(os.path.join(tmp_path / "p", f"manifest.h{h}.json")) as f:
            doc = json.load(f)
        assert doc["spec"]["max_tiles_per_pass"] < KW["max_tiles_per_pass"]
        ids = np.concatenate([np.arange(a, b) for c in doc["chunks"]
                              for a, b in c["iv"]])
        lo, hi = plan.host_tile_range(h, 2)
        np.testing.assert_array_equal(np.sort(ids), np.arange(lo, hi))
    np.testing.assert_array_equal(assemble(str(tmp_path / "p")), want)
    # the reference drops a pass's staged tiles before the chunk flush
    # that fails, while its executor counts them covered: the shards miss
    # those passes (ROADMAP C2).  The port keeps them for the next chunk.
    with pytest.raises(ValueError, match=r"missing tile ids \[\[6, 8\], "
                                         r"\[20, 22\]\]"):
        ref_assemble(str(tmp_path / "r"))


# -- the device-side top-k epilogue ------------------------------------------------------


@pytest.mark.parametrize("n,k", [(40, 3), (56, 5), (17, 4)])
def test_device_topk_bit_identical_to_host_sink(n, k):
    plan, ops, ref, ref_ops = _plans_u(n, seed=n + 7)
    want = execute_plan(plan, *ops, device="cpu", sink=TopKSink(k))
    got = execute_plan(plan, *ops, device="cpu", sink=DeviceTopKSink(k))
    np.testing.assert_array_equal(got["indices"], want["indices"])
    np.testing.assert_array_equal(got["values"], want["values"])
    ref_top = ref_execute(ref, *ref_ops, sink=RefTopKSink(k))
    np.testing.assert_array_equal(got["indices"], ref_top["indices"])
    np.testing.assert_allclose(got["values"], ref_top["values"], rtol=0,
                               atol=ATOL)


def test_device_topk_grid_bit_identical():
    plan, ops, ref, ref_ops = _plans_u(24, n_cols=40, seed=8)
    want = execute_plan(plan, *ops, device="cpu", sink=TopKSink(4))
    got = execute_plan(plan, *ops, device="cpu", sink=DeviceTopKSink(4))
    np.testing.assert_array_equal(got["indices"], want["indices"])
    np.testing.assert_array_equal(got["values"], want["values"])
    ref_top = ref_execute(ref, *ref_ops, sink=RefTopKSink(4))
    np.testing.assert_array_equal(got["indices"], ref_top["indices"])


def test_device_topk_supports_predicate_and_refusals():
    plan = ExecutionPlan.create(40, 16, **KW)
    assert DeviceTopKSink.supports(plan)
    unfused = ExecutionPlan.create(40, 16, fuse_epilogue=False, **KW)
    assert not DeviceTopKSink.supports(unfused)
    with pytest.raises(ValueError, match="fused epilogue"):
        DeviceTopKSink(3).open(unfused, torch.device("cpu"))
    quant = ExecutionPlan.create(40, 16, compute_dtype="float8_e4m3fn", **KW)
    assert not DeviceTopKSink.supports(quant)
