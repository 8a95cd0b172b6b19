"""HostSink, the checkpoint hooks of run_sink and corr(resume_from=) of the
port against repro.core on the same seeded inputs, on the CPU.

Tolerance 3e-6 against the reference (its own Pearson parity bound,
tests/test_distributed.py); inside the port, HostSink must give DenseSink's
bits and a resumed run the uninterrupted run's.  Launches are counted by a
spy on the executor's kernel seam, since the CPU runs the plain version.
The sidecar is the reference's version-2 format, so a checkpoint left by
either package resumes in the other.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import allpairs as ref_ap
from repro.core.api import corr as ref_corr
from repro.core.plan import ExecutionPlan as RefPlan
from repro.core.sinks import HostSink as RefHostSink
from repro.core.sinks import _id_intervals as ref_id_intervals
from repro.core.sinks import _ids_from_intervals as ref_ids_from_intervals
from repro.core.sinks import place_tiles_host as ref_place_tiles_host
from repro_torch.core import allpairs as ap
from repro_torch.core import sinks
from repro_torch.core.api import corr
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.sinks import DenseSink, HostSink, TopKSink

ATOL = 3e-6
# n = 37 rows at t = 8: 5 row blocks, 15 triangle tiles in passes of 4
# (4 passes, the last of 3); against 21 columns, 15 grid tiles
N, N_COLS, L = 37, 21, 29
KW = dict(t=8, l_blk=8, max_tiles_per_pass=4)


def _x(n, l, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, l)).astype(np.float32)


def _port(x, y=None, **kw):
    out = corr(x, y, device="cpu", **{**KW, **kw})
    return out.numpy() if hasattr(out, "numpy") else np.asarray(out)


def _ref(x, y=None, **kw):
    return np.asarray(ref_corr(jnp.asarray(x),
                               None if y is None else jnp.asarray(y),
                               **{**KW, **kw}))


class _Spy:
    """Counts the pass launches of the port's executor (tile ids of each)
    by wrapping its kernel seam; the CPU runs the plain version, which the
    kernel's own launch counter does not see."""

    def __init__(self, monkeypatch, module=ap, name="pcc_tiles"):
        self.starts = []
        real = getattr(module, name)

        def spy(u, j0, **k):
            self.starts.append(int(j0))
            return real(u, j0, **k)

        monkeypatch.setattr(module, name, spy)


class _StopAfter(HostSink):
    """A HostSink whose run stops right after pass `k` is committed."""

    def __init__(self, path, k):
        super().__init__(path=path)
        self._stop = k

    def pass_complete(self, k):
        super().pass_complete(k)
        if k == self._stop:
            raise RuntimeError(f"stopped after pass {k}")


class _RefStopAfter(RefHostSink):
    """The reference's HostSink, stopped the same way."""

    def __init__(self, path, k):
        super().__init__(path=path)
        self._stop = k

    def pass_complete(self, k):
        super().pass_complete(k)
        if k == self._stop:
            raise RuntimeError(f"stopped after pass {k}")


@pytest.mark.parametrize("kind", ["ndarray", "memmap", "out"])
@pytest.mark.parametrize("rect", [False, True])
@pytest.mark.parametrize("measure", ["pearson", "covariance"])
def test_host_sink_matches_reference_and_dense(tmp_path, kind, rect,
                                               measure):
    x = _x(N, L)
    y = _x(N_COLS, L, seed=1) if rect else None
    plan = ExecutionPlan.create(N, L, n_cols=N_COLS if rect else None,
                                t=8, l_blk=8, measure=measure)

    def sink(cls, name):
        if kind == "memmap":
            return cls(path=str(tmp_path / name))
        if kind == "out":
            return cls(out=np.full((plan.n_pad, plan.col_pad), 0.0,
                                   np.float32))
        return cls()

    got = _port(x, y, measure=measure, sink=sink(HostSink, "p.mm"))
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == (N, N_COLS if rect else N)
    np.testing.assert_array_equal(got, _port(x, y, measure=measure))
    want = _ref(x, y, measure=measure, sink=sink(RefHostSink, "r.mm"))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    if not rect:
        np.testing.assert_array_equal(got, got.T)
    if kind == "memmap":
        # the memmap really is the backing store
        reread = np.memmap(tmp_path / "p.mm", dtype=np.float32, mode="r",
                           shape=(plan.n_pad, plan.col_pad))
        np.testing.assert_array_equal(reread[:got.shape[0], :got.shape[1]],
                                      got)


def test_host_sink_argument_checks(tmp_path):
    with pytest.raises(ValueError, match="not both"):
        HostSink(out=np.zeros((8, 8), np.float32), path=str(tmp_path / "a"))
    with pytest.raises(ValueError, match="requires a memmap"):
        HostSink(resume=True)
    with pytest.raises(ValueError, match="out shape"):
        _port(_x(N, L), sink=HostSink(out=np.zeros((8, 8), np.float32)))


@pytest.mark.parametrize("stop", [0, 1, 2])
@pytest.mark.parametrize("rect", [False, True])
def test_stop_after_a_pass_and_resume(tmp_path, monkeypatch, stop, rect):
    """A run stopped once pass `stop` is committed resumes with exactly the
    passes after it, and gives the uninterrupted run's bits."""
    x = _x(N, L, seed=2)
    y = _x(N_COLS, L, seed=3) if rect else None
    path = str(tmp_path / "s.mm")
    with pytest.raises(RuntimeError, match=f"after pass {stop}"):
        _port(x, y, sink=_StopAfter(path, stop))
    prog = json.loads((tmp_path / "s.mm.progress.json").read_text())
    assert prog["version"] == 2 and prog["completed"] == stop
    assert len(prog["entries"]) == stop + 1
    spy = _Spy(monkeypatch)
    resumed = _port(x, y, resume_from=path)
    plan = ExecutionPlan.create(N, L, n_cols=N_COLS if rect else None, t=8,
                                l_blk=8, max_tiles_per_pass=4)
    assert spy.starts == [plan.pass_offset(k)
                          for k in range(stop + 1, plan.n_pass)]
    np.testing.assert_array_equal(resumed, _port(x, y))
    done = json.loads((tmp_path / "s.mm.progress.json").read_text())
    assert done["completed"] == plan.n_pass - 1
    # a finished checkpoint resumes with no launch at all
    spy.starts.clear()
    np.testing.assert_array_equal(_port(x, y, resume_from=path), resumed)
    assert spy.starts == []


def test_stop_mid_pass_reruns_only_that_pass(tmp_path, monkeypatch):
    """A run killed inside pass 2's consume (before its commit) reruns pass
    2 and the rest: the partly written pass is not trusted."""

    class Killed(HostSink):
        def consume(self, ids, tiles, ready=None):
            if ids[0] == 8:
                super().consume(ids[:2], tiles[:2], ready)
                raise RuntimeError("killed mid-pass")
            super().consume(ids, tiles, ready)

    x = _x(N, L, seed=4)
    path = str(tmp_path / "k.mm")
    with pytest.raises(RuntimeError, match="mid-pass"):
        _port(x, sink=Killed(path=path))
    spy = _Spy(monkeypatch)
    got = _port(x, resume_from=path)
    assert spy.starts == [8, 12]
    np.testing.assert_array_equal(got, _port(x))


@pytest.mark.parametrize("bad_pass", [0, 2, 3])
def test_corrupt_region_dropped_and_recomputed(tmp_path, monkeypatch,
                                               bad_pass):
    """Bytes flipped inside one committed pass's tiles fail that entry's
    CRC: exactly that pass is launched again, and the bits come back."""
    x = _x(N, L, seed=5)
    path = str(tmp_path / "c.mm")
    full = _port(x, sink=HostSink(path=path))
    plan = ExecutionPlan.create(N, L, t=8, l_blk=8, max_tiles_per_pass=4)
    ids = plan.pass_ids(bad_pass)
    ys, xs = plan.workload.job_coord_batch(ids[-1:])
    mm = np.memmap(path, dtype=np.float32, mode="r+",
                   shape=(plan.n_pad, plan.n_pad))
    r0, c0 = int(ys[0]) * 8, int(xs[0]) * 8
    mm[r0 + 1, c0 + 2] = np.float32(7.0)
    mm[r0 + 3, c0:c0 + 4] = -mm[r0 + 3, c0:c0 + 4] - 1.0
    mm.flush()
    del mm
    spy = _Spy(monkeypatch)
    got = _port(x, resume_from=path)
    assert spy.starts == [plan.pass_offset(bad_pass)]
    np.testing.assert_array_equal(got, full)
    prog = json.loads((tmp_path / "c.mm.progress.json").read_text())
    # the watermark is the last pass committed, as in the reference
    assert len(prog["entries"]) == plan.n_pass
    assert prog["completed"] == bad_pass


def test_resume_refuses_mismatched_or_missing_checkpoints(tmp_path):
    x = _x(24, 10, seed=6)
    kw = dict(t=8, l_blk=8)
    path = str(tmp_path / "s.mm")
    corr(x, device="cpu", max_tiles_per_pass=2, sink=HostSink(path=path),
         **kw)
    for other in (dict(max_tiles_per_pass=3), dict(measure="cosine"),
                  dict(max_tiles_per_pass=2, clip=False)):
        with pytest.raises(ValueError, match="does not match"):
            corr(x, device="cpu", resume_from=path, **{**kw, **other})
    with pytest.raises(ValueError, match="unreadable"):
        corr(x, device="cpu", resume_from=str(tmp_path / "missing.mm"),
             **kw)
    (tmp_path / "g.mm.progress.json").write_text(json.dumps(
        {"version": 2, "spec": {}, "entries": []}))
    with pytest.raises(ValueError, match="garbled"):
        corr(x, device="cpu", resume_from=str(tmp_path / "g.mm"), **kw)


def test_corr_resume_from_takes_only_a_host_sink_of_its_path(tmp_path,
                                                            monkeypatch):
    x = _x(N, L, seed=7)
    path = str(tmp_path / "a.mm")
    with pytest.raises(RuntimeError):
        _port(x, sink=_StopAfter(path, 1))
    for sink in (DenseSink(), TopKSink(3),
                 HostSink(path=str(tmp_path / "b.mm"))):
        with pytest.raises(ValueError, match="HostSink"):
            _port(x, resume_from=path, sink=sink)
    # a HostSink of that very path is switched to resume
    spy = _Spy(monkeypatch)
    got = _port(x, resume_from=path, sink=HostSink(path=path))
    assert spy.starts == [8, 12]
    np.testing.assert_array_equal(got, _port(x))


@pytest.mark.parametrize("stop", [0, 2])
def test_reference_checkpoint_resumes_in_the_port(tmp_path, monkeypatch,
                                                  stop):
    """A float32 Pearson checkpoint the reference left half done resumes in
    the port: the same spec, the reference's CRCs verified, only the
    missing passes launched."""
    x = _x(N, L, seed=8)
    path = str(tmp_path / "j.mm")
    with pytest.raises(RuntimeError, match="stopped"):
        ref_corr(jnp.asarray(x), sink=_RefStopAfter(path, stop), **KW)
    spy = _Spy(monkeypatch)
    got = _port(x, resume_from=path)
    plan = ExecutionPlan.create(N, L, t=8, l_blk=8, max_tiles_per_pass=4)
    assert spy.starts == [plan.pass_offset(k)
                          for k in range(stop + 1, plan.n_pass)]
    np.testing.assert_allclose(got, _port(x), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, _ref(x), rtol=0, atol=ATOL)
    # the reference's own tiles were kept as they were
    ref_full = _ref(x)
    for k in range(stop + 1):
        ys, xs = plan.workload.job_coord_batch(plan.pass_ids(k))
        for y, c in zip(ys, xs):
            blk = np.s_[y * 8:min(N, y * 8 + 8), c * 8:min(N, c * 8 + 8)]
            np.testing.assert_array_equal(got[blk], ref_full[blk])


@pytest.mark.parametrize("stop", [0, 2])
def test_port_checkpoint_resumes_in_the_reference(tmp_path, monkeypatch,
                                                  stop):
    """And the other way round: the port's half-done checkpoint resumes in
    the reference package, which launches only the missing passes."""
    x = _x(N, L, seed=9)
    path = str(tmp_path / "t.mm")
    with pytest.raises(RuntimeError, match="stopped"):
        _port(x, sink=_StopAfter(path, stop))
    seen = []
    real = ref_ap.pcc_tiles

    def spy(u, j0, **k):
        seen.append(int(j0))
        return real(u, j0, **k)

    monkeypatch.setattr(ref_ap, "pcc_tiles", spy)
    got = np.asarray(ref_corr(jnp.asarray(x), resume_from=path, **KW))
    plan = RefPlan.create(N, L, t=8, l_blk=8, max_tiles_per_pass=4)
    assert seen == [plan.pass_offset(k) for k in range(stop + 1, plan.n_pass)]
    np.testing.assert_allclose(got, _ref(x), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, _port(x), rtol=0, atol=ATOL)


def test_spec_dicts_agree_across_packages():
    """The sidecar's identity: the port's spec_dict is the reference's for
    the float32 Pearson plans either resumes."""
    for n_cols in (None, N_COLS):
        for mtp in (None, 4):
            kw = dict(n_cols=n_cols, t=8, l_blk=8, max_tiles_per_pass=mtp)
            assert ExecutionPlan.create(N, L, **kw).spec_dict() == \
                RefPlan.create(N, L, **kw).spec_dict()


def test_version_1_sidecar_resumes_and_is_upgraded(tmp_path, monkeypatch):
    """A sidecar of the first format (a completed-pass watermark, no
    coverage entries, no CRCs): both packages trust its prefix, launch the
    same passes (the rest), give the uninterrupted result and rewrite it as
    version 2 with one verified entry for the prefix."""
    x = _x(N, L, seed=10)
    path = str(tmp_path / "v.mm")
    with pytest.raises(RuntimeError):
        _port(x, sink=_StopAfter(path, 1))
    prog = json.loads((tmp_path / "v.mm.progress.json").read_text())
    data = (tmp_path / "v.mm").read_bytes()
    v1 = json.dumps({"version": 1, "spec": prog["spec"], "completed": 1})
    paths = {}
    for who in ("port", "reference"):
        paths[who] = str(tmp_path / f"{who}.mm")
        (tmp_path / f"{who}.mm").write_bytes(data)
        (tmp_path / f"{who}.mm.progress.json").write_text(v1)
    spy = _Spy(monkeypatch)
    seen = []
    real = ref_ap.pcc_tiles

    def ref_spy(u, j0, **k):
        seen.append(int(j0))
        return real(u, j0, **k)

    monkeypatch.setattr(ref_ap, "pcc_tiles", ref_spy)
    got = _port(x, resume_from=paths["port"])
    want = np.asarray(ref_corr(jnp.asarray(x), resume_from=paths["reference"],
                               **KW))
    assert spy.starts == seen == [8, 12]
    np.testing.assert_array_equal(got, _port(x))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    for who in ("port", "reference"):
        prog = json.loads((tmp_path / f"{who}.mm.progress.json").read_text())
        assert prog["version"] == 2 and prog["completed"] == 3
        assert [e["iv"] for e in prog["entries"]] == [[[0, 8]], [[8, 12]],
                                                      [[12, 15]]]


@pytest.mark.parametrize("seed", range(4))
def test_coverage_schedule_matches_reference(seed):
    rng = np.random.default_rng(seed)
    for n_cols in (None, N_COLS):
        kw = dict(n_cols=n_cols, t=8, l_blk=8, max_tiles_per_pass=3)
        plan = ExecutionPlan.create(N, L, **kw)
        ref = RefPlan.create(N, L, **kw)
        for _ in range(20):
            cov = rng.random(plan.total_tiles) < rng.random()
            if rng.random() < 0.5:   # a committed prefix
                cov[:rng.integers(0, plan.total_tiles + 1)] = True
            assert plan.coverage_schedule(cov) == ref.coverage_schedule(cov)
        for k in range(plan.n_pass):
            assert np.array_equal(plan.pass_ids(k), ref.pass_selection(k)[0])
        with pytest.raises(ValueError, match="coverage bitmap"):
            plan.coverage_schedule(np.zeros(plan.total_tiles + 1, bool))


def test_id_intervals_and_place_tiles_match_reference():
    rng = np.random.default_rng(11)
    for _ in range(20):
        ids = np.unique(rng.integers(0, 60, size=rng.integers(0, 40)))
        ivs = sinks._id_intervals(ids)
        assert ivs == ref_id_intervals(ids)
        assert np.array_equal(sinks._ids_from_intervals(ivs), ids)
        assert np.array_equal(ref_ids_from_intervals(ivs), ids)
    for n_cols in (None, N_COLS):
        plan = ExecutionPlan.create(N, L, n_cols=n_cols, t=8)
        for ids in (np.array([0, 1, 4, 5, 9, 12, 14]),
                    np.arange(plan.total_tiles),
                    rng.permutation(plan.total_tiles)[:9]):
            tiles = rng.standard_normal((len(ids), 8, 8)).astype(np.float32)
            ys, xs = plan.workload.job_coord_batch(ids)
            # the grid has no transpose twin: it never mirrors
            for mirror in (True, False) if n_cols is None else (False,):
                a = np.zeros((plan.n_pad, plan.col_pad), np.float32)
                b = np.zeros_like(a)
                sinks.place_tiles_host(a, tiles, ys, xs, 8, mirror=mirror)
                ref_place_tiles_host(b, tiles, ys, xs, 8, mirror=mirror)
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("rect", [False, True])
def test_crc_of_ids_matches_reference(rect):
    """The sidecar's CRC32 of a set of tiles is the reference's, byte for
    byte, for any id set: the port reads the tiles run by run, the
    reference gathers them element by element."""
    rng = np.random.default_rng(14)
    kw = dict(n_cols=N_COLS if rect else None, t=8, l_blk=8)
    port, ref = HostSink(), RefHostSink()
    port.plan = ExecutionPlan.create(N, L, **kw)
    ref.plan = RefPlan.create(N, L, **kw)
    shape = (port.plan.n_pad, port.plan.col_pad)
    port.r = ref.r = rng.standard_normal(shape).astype(np.float32)
    total = port.plan.total_tiles
    for ids in (np.arange(total), np.arange(3, 9), np.array([2]),
                np.unique(rng.integers(0, total, size=7)),
                np.empty(0, np.int64)):
        assert port._crc_of_ids(ids) == ref._crc_of_ids(ids)


def test_run_sink_hooks_default_for_duck_typed_sinks(monkeypatch):
    """A sink with only open / consume / result (none of the checkpoint
    hooks) gets every pass, in order, and the TileSink defaults say the
    same."""

    class Duck:
        def open(self, plan, device):
            self.plan, self.seen = plan, []

        def consume(self, ids, tiles, ready=None):
            self.seen.append((int(ids[0]), tuple(tiles.shape)))

        def result(self):
            return self.seen

    x = _x(N, L, seed=12)
    spy = _Spy(monkeypatch)
    seen = corr(x, device="cpu", sink=Duck(), **KW)
    assert [s for s, _ in seen] == [0, 4, 8, 12] == spy.starts
    assert [shape[0] for _, shape in seen] == [4, 4, 4, 3]
    dense = DenseSink()
    assert dense.resume_pass() == 0 and dense.skip_passes() == set()
    assert dense.covered() is None and dense.pass_complete(0) is None


def test_run_sink_skips_what_the_sink_holds(monkeypatch):
    """run_sink builds the stream from resume_pass() and skip_passes() and
    calls pass_complete(k) after each pass it consumed, as the reference's
    does; masked runs honour the same hooks."""

    class Holding(DenseSink):
        def resume_pass(self):
            return 1

        def skip_passes(self):
            return {2}

        def pass_complete(self, k):
            self.done.append(k)

        def open(self, plan, device):
            super().open(plan, device)
            self.done = []

    x = _x(N, L, seed=13)
    spy = _Spy(monkeypatch)
    sink = Holding()
    corr(x, device="cpu", sink=sink, **KW)
    assert spy.starts == [4, 12] and sink.done == [1, 3]
    spy.starts.clear()
    x[0, 3] = np.nan
    sink = Holding()
    corr(x, device="cpu", where="nan", sink=sink, **KW)
    assert sink.done == [1, 3]
    assert sorted(set(spy.starts)) == [4, 12]
