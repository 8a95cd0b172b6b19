"""Fault injection and self-healing execution of the port against the
reference, case for case with tests/test_faults.py (all but the 8-device
mesh shrink, ROADMAP A6), on the CPU.

Every scenario runs both packages under equal FaultPlans (each package arms
its own) and checks that they fire the same faults (``plan.fired``) and
write the same recovery log (``policy.log``, key for key, error strings
included: both packages word an injected fault alike), that the port's
recovered result is bitwise its own fault-free run, and that it lies
within 3e-6 of the reference's (its own Pearson parity bound,
tests/test_distributed.py).  A device loss on one device is resolved by
``on_device_loss=lambda mesh, pl, exc: (mesh, pl)`` in the port, which is
the reference's ``pl.repartition(1)`` at p = 1 (asserted through
``spec_dict()``).  Checkpoints crashed by either package resume in the
other.  Launches are counted by spies on both executors' kernel seams.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import allpairs as ref_ap
from repro.core.api import corr as ref_corr
from repro.core.plan import ExecutionPlan as RefPlan
from repro.core.significance import PermutationSpec as RefSpec
from repro.core.sinks import DeviceTopKSink as RefDeviceTopKSink
from repro.core.sinks import HostSink as RefHostSink
from repro.core.sinks import TopKSink as RefTopKSink
from repro.runtime import faults as ref_faults
from repro_torch.core import allpairs as ap
from repro_torch.core.allpairs import execute_plan
from repro_torch.core.api import corr
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.significance import PermutationSpec
from repro_torch.core.sinks import (DeviceTopKSink, EdgeCountSink, HostSink,
                                    ReductionSink, RowBlockSink, TopKSink)
from repro_torch.runtime import faults
from repro_torch.runtime.faults import (CrashFault, DeviceLostFault,
                                        FaultPlan, FaultSpec, OomFault,
                                        RetryPolicy, TransientFault,
                                        classify_failure)

pytestmark = pytest.mark.chaos

ATOL = 3e-6
KW = dict(t=8, l_blk=8, max_tiles_per_pass=4)       # 40 x 16: 15 tiles, 4 passes
GRID_KW = dict(t=8, l_blk=8, max_tiles_per_pass=2)  # 24 x 40: 15 tiles


def _x(n, l, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, l)).astype(np.float32)


def _np(r):
    return r.numpy() if isinstance(r, torch.Tensor) else np.asarray(r)


def _port(x, y=None, **kw):
    return corr(x, y, device="cpu", **{**KW, **kw})


def _ref(x, y=None, **kw):
    return ref_corr(jnp.asarray(x), None if y is None else jnp.asarray(y),
                    **{**KW, **kw})


def _plans(*specs):
    """Equal FaultPlans of the two packages from FaultSpec arguments
    (site, kind, at[, fraction])."""
    return (ref_faults.FaultPlan([ref_faults.FaultSpec(*s) for s in specs]),
            FaultPlan([FaultSpec(*s) for s in specs]))


def _policies(**kw):
    kw.setdefault("sleep", lambda _s: None)  # full-speed chaos
    return ref_faults.RetryPolicy(**kw), RetryPolicy(**kw)


def _same_recovery(ref_plan, plan, ref_pol, pol):
    assert plan.fired == ref_plan.fired
    assert pol.log == ref_pol.log


def _run_both(specs, x, y=None, *, policy_kw=None, ref_kw=None,
              port_kw=None, **kw):
    """One recovering run of each package under equal fault plans; checks
    fired faults and logs, and returns (reference result, port result,
    port policy)."""
    ref_plan, plan = _plans(*specs)
    ref_pol, pol = _policies(**(policy_kw or {}))
    with ref_plan.armed():
        want = _ref(x, y, recovery=ref_pol, **kw, **(ref_kw or {}))
    with plan.armed():
        got = _port(x, y, recovery=pol, **kw, **(port_kw or {}))
    _same_recovery(ref_plan, plan, ref_pol, pol)
    return want, got, pol


def _same_bits(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape and a.tobytes() == b.tobytes()


def _same_topk(a, b):
    assert np.array_equal(a["indices"], b["indices"])
    assert np.asarray(a["values"]).tobytes() == \
        np.asarray(b["values"]).tobytes()


class _Spies:
    """The tile starts each package's executor launches, by spies on its
    kernel seam (the port's CPU runs the plain version, which the kernel's
    launch counter does not see)."""

    def __init__(self, monkeypatch):
        self.port, self.ref = [], []
        for module, seen in ((ap, self.port), (ref_ap, self.ref)):
            real = module.pcc_tiles

            def spy(u, j0, _real=real, _seen=seen, **k):
                _seen.append(int(np.asarray(j0)))
                return _real(u, j0, **k)

            monkeypatch.setattr(module, "pcc_tiles", spy)


# -- FaultPlan mechanics, both packages alike ---------------------------------------

MODULES = [pytest.param(ref_faults, id="reference"),
           pytest.param(faults, id="port")]


@pytest.mark.parametrize("mod", MODULES)
def test_fault_spec_validation(mod):
    with pytest.raises(ValueError, match="unknown fault site"):
        mod.FaultSpec("warp_core", "transient", (1,))
    with pytest.raises(ValueError, match="unknown fault kind"):
        mod.FaultSpec("pass_launch", "gremlins", (1,))
    with pytest.raises(ValueError, match="1-based"):
        mod.FaultSpec("pass_launch", "transient", (0,))
    assert mod.SITES == faults.SITES == ref_faults.SITES
    assert set(mod.FAULT_KINDS) == set(ref_faults.FAULT_KINDS)


def test_check_fires_at_exact_arrivals():
    for mod in (ref_faults, faults):
        plan = mod.FaultPlan([mod.FaultSpec("pass_launch", "transient",
                                            (2, 3))])
        with plan.armed():
            mod.check("pass_launch")                    # arrival 1: clean
            with pytest.raises(mod.TransientFault) as e2:
                mod.check("pass_launch")                # arrival 2: fires
            with pytest.raises(mod.TransientFault):
                mod.check("pass_launch")                # arrival 3: fires
            mod.check("pass_launch")                    # arrival 4: clean
            mod.check("sink_write")                     # other site: clean
        assert e2.value.site == "pass_launch" and e2.value.arrival == 2
        assert str(e2.value) == ("injected transient fault at "
                                 "'pass_launch' (arrival 2)")
        assert plan.fired == [("pass_launch", 2, "transient"),
                              ("pass_launch", 3, "transient")]
        assert plan.arrivals("pass_launch") == 4
        mod.check("pass_launch")                        # disarmed: no-op
        assert plan.arrivals("pass_launch") == 4


def test_armed_restores_previous_plan():
    """Each package arms its own plan: arming one never arms the other."""
    for mod, other in ((ref_faults, faults), (faults, ref_faults)):
        outer, inner = mod.FaultPlan(), mod.FaultPlan()
        assert mod.active_plan() is None
        with outer.armed():
            assert other.active_plan() is None
            with inner.armed():
                assert mod.active_plan() is inner
            assert mod.active_plan() is outer
        assert mod.active_plan() is None


@pytest.mark.parametrize("mod", MODULES)
def test_partial_write_poll_carries_fraction(mod):
    plan = mod.FaultPlan.single("sink_write", "partial_write", fraction=0.25)
    with plan.armed():
        fault = mod.poll("sink_write")
    assert isinstance(fault, mod.PartialWriteFault)
    assert fault.fraction == 0.25
    assert isinstance(fault, OSError)  # sinks may catch it as real I/O


def test_scenario_is_seed_deterministic():
    """Both packages draw the same seeded schedule."""
    a = FaultPlan.scenario(7, rate=0.4, horizon=25)
    b = FaultPlan.scenario(7, rate=0.4, horizon=25)
    assert a.specs == b.specs and len(a.specs) > 0
    assert FaultPlan.scenario(8, rate=0.4, horizon=25).specs != a.specs
    ref = ref_faults.FaultPlan.scenario(7, rate=0.4, horizon=25)
    assert [(s.site, s.kind, s.at, s.fraction) for s in a.specs] == \
        [(s.site, s.kind, s.at, s.fraction) for s in ref.specs]


def test_classify_failure_taxonomy():
    """Injected faults classify alike in both packages; the port reads its
    own real failures (torch.cuda's out-of-memory error, the CUDA
    runtime's strings) where the reference reads XLA status prefixes."""
    for mod in (ref_faults, faults):
        assert mod.classify_failure(
            mod.TransientFault("pass_launch", 1)) == "transient"
        assert mod.classify_failure(
            mod.SinkIOFault("sink_write", 1)) == "transient"
        assert mod.classify_failure(mod.OomFault("pass_launch", 1)) == "oom"
        assert mod.classify_failure(
            mod.DeviceLostFault("pass_launch", 1)) == "device_loss"
        assert mod.classify_failure(
            mod.CrashFault("sink_commit", 1)) == "crash"
        assert mod.classify_failure(ValueError("boom")) == "fatal"
    assert classify_failure(torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 316.00 MiB")) == "oom"
    assert classify_failure(RuntimeError(
        "CUDA error: uncorrectable ECC error encountered")) == "device_loss"
    assert classify_failure(RuntimeError(
        "pcc_tiles launch failed: an illegal memory access was "
        "encountered")) == "fatal"
    assert classify_failure(RuntimeError(
        "CUDA error: CUDA-capable device(s) is/are busy or "
        "unavailable")) == "transient"
    assert classify_failure(RuntimeError("INVALID_ARGUMENT")) == "fatal"


def test_retry_policy_backoff_is_exponential_and_capped():
    for mod in (ref_faults, faults):
        p = mod.RetryPolicy(backoff_s=0.1, backoff_factor=2.0,
                            max_backoff_s=0.5)
        assert [p.backoff(i) for i in range(4)] == [0.1, 0.2, 0.4, 0.5]


# -- the recovering executor: retry, shrink the pass, device loss --------------------


def test_transient_pass_launch_retried_bit_identical():
    x = _x(40, 16, seed=1)
    baseline = _port(x)
    want, got, pol = _run_both([("pass_launch", "transient", (2, 3))], x)
    _same_bits(got, baseline)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=ATOL)
    assert [e["action"] for e in pol.log] == ["retry", "retry"]


def test_transient_budget_exhausted_raises():
    x = _x(40, 16, seed=2)
    ref_plan, plan = _plans(("pass_launch", "transient", tuple(range(1, 11))))
    ref_pol, pol = _policies(max_retries=3)
    with ref_plan.armed(), pytest.raises(ref_faults.TransientFault):
        _ref(x, recovery=ref_pol)
    with plan.armed(), pytest.raises(TransientFault):
        _port(x, recovery=pol)
    _same_recovery(ref_plan, plan, ref_pol, pol)
    assert pol.log[-1]["action"] == "give_up"
    assert sum(e["action"] == "retry" for e in pol.log) == 3


def test_transient_budget_refills_on_forward_progress():
    """Two faults far enough apart that passes land between them stay
    within a budget of one: every landed pass resets the count."""
    x = _x(40, 16, seed=3)
    baseline = _port(x)
    want, got, pol = _run_both([("pass_launch", "transient", (1, 5))], x,
                               policy_kw=dict(max_retries=1))
    _same_bits(got, baseline)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=ATOL)
    assert sum(e["action"] == "retry" for e in pol.log) == 2
    assert not any(e["action"] == "give_up" for e in pol.log)


def test_oom_halves_pass_and_completes():
    x = _x(40, 16, seed=4)
    baseline = _port(x)
    want, got, pol = _run_both([("pass_launch", "oom", (2,))], x)
    _same_bits(got, baseline)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=ATOL)
    assert [e for e in pol.log if e["action"] == "shrink_pass"] == [
        {"kind": "oom", "action": "shrink_pass", "max_tiles_per_pass": 2}]


def test_oom_at_floor_raises():
    x = _x(16, 8, seed=5)
    ref_plan, plan = _plans(("pass_launch", "oom", tuple(range(1, 21))))
    ref_pol, pol = _policies()
    with ref_plan.armed(), pytest.raises(ref_faults.OomFault):
        _ref(x, max_tiles_per_pass=2, recovery=ref_pol)
    with plan.armed(), pytest.raises(OomFault):
        _port(x, max_tiles_per_pass=2, recovery=pol)
    _same_recovery(ref_plan, plan, ref_pol, pol)
    assert pol.log[-1] == {"kind": "oom", "action": "give_up",
                           "max_tiles_per_pass": 1}


def _keep_plan(mesh, pl, exc):
    """The port's survivor resolution on one device: the same plan (the
    reference's pl.repartition(1) at p = 1)."""
    return mesh, pl


def _ref_repartition(mesh, pl, exc):
    return mesh, pl.repartition(1)


def test_device_loss_shrinks_and_continues():
    """The on_device_loss seam hands back the same plan, and the executor
    resumes from coverage without recomputing landed passes."""
    x = _x(40, 16, seed=6)
    baseline = _port(x)
    seen = []

    def keep(mesh, pl, exc):
        seen.append(pl)
        return _keep_plan(mesh, pl, exc)

    ref_plan, plan = _plans(("pass_launch", "device_loss", (3,)))
    ref_pol = ref_faults.RetryPolicy(sleep=lambda s: None,
                                     on_device_loss=_ref_repartition)
    pol = RetryPolicy(sleep=lambda s: None, on_device_loss=keep)
    with ref_plan.armed():
        want = _ref(x, recovery=ref_pol)
    with plan.armed():
        got = _port(x, recovery=pol)
    _same_recovery(ref_plan, plan, ref_pol, pol)
    _same_bits(got, baseline)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=ATOL)
    assert [e["action"] for e in pol.log] == ["shrink_mesh"]
    assert seen[0].spec_dict() == \
        RefPlan.create(40, 16, **KW).repartition(1).spec_dict()


def test_device_loss_without_mesh_is_fatal_by_default():
    x = _x(40, 16, seed=7)
    ref_plan, plan = _plans(("pass_launch", "device_loss", (1,)))
    ref_pol, pol = _policies()
    with ref_plan.armed(), pytest.raises(ref_faults.DeviceLostFault):
        _ref(x, recovery=ref_pol)
    with plan.armed(), pytest.raises(DeviceLostFault):
        _port(x, recovery=pol)
    _same_recovery(ref_plan, plan, ref_pol, pol)
    assert pol.log == []   # the default resolver re-raises before logging


def test_recovery_rejects_masked_and_pvalue_runs():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((12, 10)).astype(np.float32)
    x[0, 0] = np.nan
    ref_pol, pol = _policies()
    with pytest.raises(ValueError, match="recovery=") as want:
        ref_corr(jnp.asarray(x), where="nan", recovery=ref_pol, t=8,
                 l_blk=8)
    with pytest.raises(ValueError, match="recovery=") as got:
        corr(x, where="nan", recovery=pol, t=8, l_blk=8, device="cpu")
    assert str(got.value) == str(want.value)
    x[0, 0] = 0.0
    with pytest.raises(ValueError, match="recovery="):
        ref_corr(jnp.asarray(x), recovery=ref_pol, t=8, l_blk=8,
                 pvalues=RefSpec(iterations=4, key=0))
    with pytest.raises(ValueError, match="recovery="):
        corr(x, recovery=pol, t=8, l_blk=8, device="cpu",
             pvalues=PermutationSpec(iterations=4, key=0))


# -- the recovering executor over rectangular grids ------------------------------------


def test_grid_transient_retry_bit_identical():
    x, y = _x(24, 16, seed=9), _x(40, 16, seed=10)
    baseline = _port(x, y, **GRID_KW)
    want, got, pol = _run_both([("pass_launch", "transient", (3, 4))], x, y,
                               **GRID_KW)
    _same_bits(got, baseline)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=ATOL)
    assert [e["action"] for e in pol.log] == ["retry", "retry"]


def test_grid_oom_halves_pass_and_completes():
    x, y = _x(24, 16, seed=11), _x(40, 16, seed=12)
    baseline = _port(x, y, **GRID_KW)
    want, got, pol = _run_both([("pass_launch", "oom", (4,))], x, y,
                               **GRID_KW)
    _same_bits(got, baseline)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=ATOL)
    assert [e["action"] for e in pol.log] == ["shrink_pass"]


def test_grid_device_loss_resumes_from_coverage():
    x, y = _x(24, 16, seed=13), _x(40, 16, seed=14)
    baseline = _port(x, y, **GRID_KW)
    ref_plan, plan = _plans(("pass_launch", "device_loss", (3,)))
    ref_pol = ref_faults.RetryPolicy(sleep=lambda s: None,
                                     on_device_loss=_ref_repartition)
    pol = RetryPolicy(sleep=lambda s: None, on_device_loss=_keep_plan)
    with ref_plan.armed():
        want = _ref(x, y, recovery=ref_pol, **GRID_KW)
    with plan.armed():
        got = _port(x, y, recovery=pol, **GRID_KW)
    _same_recovery(ref_plan, plan, ref_pol, pol)
    _same_bits(got, baseline)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=ATOL)
    assert [e["action"] for e in pol.log] == ["shrink_mesh"]


@pytest.mark.parametrize("device_state", [False, True])
def test_grid_topk_recovery_bit_identical(device_state):
    """TopKSink (tiles cut to the fresh ones) and DeviceTopKSink (the
    state tuple whole, duplicates dropped by the canonical merge)."""
    x, y = _x(24, 16, seed=15), _x(40, 16, seed=16)
    port_cls, ref_cls = ((DeviceTopKSink, RefDeviceTopKSink) if device_state
                         else (TopKSink, RefTopKSink))
    baseline = _port(x, y, sink=port_cls(4), **GRID_KW)
    want, got, _ = _run_both(
        [("pass_launch", "transient", (2,)), ("pass_launch", "oom", (5,))],
        x, y, ref_kw=dict(sink=ref_cls(4)), port_kw=dict(sink=port_cls(4)),
        **GRID_KW)
    _same_topk(got, baseline)
    np.testing.assert_array_equal(got["indices"], np.asarray(
        want["indices"]))
    np.testing.assert_allclose(got["values"], np.asarray(want["values"]),
                               rtol=0, atol=ATOL)


# -- crash-atomic, self-verifying checkpoints -----------------------------------------


def test_partial_write_never_committed_and_result_exact(tmp_path):
    """An I/O fault midway through a tile batch leaves the pass
    uncommitted; the retry rewrites the whole batch."""
    x = _x(40, 16, seed=9)
    baseline = _port(x)
    want, got, pol = _run_both(
        [("sink_write", "partial_write", (2,), 0.5)], x,
        ref_kw=dict(sink=RefHostSink(path=str(tmp_path / "r.mm"))),
        port_kw=dict(sink=HostSink(path=str(tmp_path / "p.mm"))))
    _same_bits(got, baseline)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)
    assert [e["action"] for e in pol.log] == ["retry"]
    for name in ("r.mm", "p.mm"):
        prog = json.loads((tmp_path / f"{name}.progress.json").read_text())
        assert prog["completed"] == 3  # all 4 passes committed in the end


def _crash(tmp_path, name, at, x, *, port, policy=True, **kw):
    """One package's HostSink(path=) run crashed at sink_commit arrival
    `at` (1 = open's sidecar, 2.. = passes 0..); returns its path, plan
    and policy."""
    path = str(tmp_path / name)
    mod = faults if port else ref_faults
    plan = mod.FaultPlan.single("sink_commit", "crash", at=at)
    pol = mod.RetryPolicy(sleep=lambda s: None) if policy else None
    with plan.armed(), pytest.raises(mod.CrashFault):
        if port:
            _port(x, sink=HostSink(path=path), recovery=pol, **kw)
        else:
            _ref(x, sink=RefHostSink(path=path), recovery=pol, **kw)
    return path, plan, pol


def test_crash_before_commit_propagates_then_resumes(tmp_path):
    """A crash at the sidecar commit (before the rename) is not handled
    in-process even with recovery armed; a restart with resume_from=
    recomputes exactly the uncommitted passes."""
    x = _x(40, 16, seed=10)
    baseline = _port(x)
    rp, ref_plan, ref_pol = _crash(tmp_path, "r.mm", 4, x, port=False)
    pp, plan, pol = _crash(tmp_path, "p.mm", 4, x, port=True)
    _same_recovery(ref_plan, plan, ref_pol, pol)
    assert [e["action"] for e in pol.log] == ["raise"]
    for p in (rp, pp):
        assert json.loads(open(p + ".progress.json").read())[
            "completed"] == 1   # pass 2's commit is the one that died
    got = _port(x, resume_from=pp)
    _same_bits(got, baseline)
    np.testing.assert_allclose(_np(got), _np(_ref(x, resume_from=rp)),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_crashed_checkpoint_resumes_in_the_other_package(tmp_path,
                                                         monkeypatch,
                                                         writer):
    """A HostSink crashed at sink_commit by one package resumes in the
    other, which launches only the passes the sidecar lacks."""
    x = _x(37, 29, seed=20)
    path, _, _ = _crash(tmp_path, "c.mm", 3, x, port=writer == "port")
    spies = _Spies(monkeypatch)
    if writer == "port":
        got = np.asarray(_ref(x, resume_from=path, recovery=_policies()[0]))
        seen = spies.ref
    else:
        got = _np(_port(x, resume_from=path, recovery=_policies()[1]))
        seen = spies.port
    assert seen == [4, 8, 12]          # pass 0 committed; passes 1-3 rerun
    np.testing.assert_allclose(got, _np(_port(x)), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(_ref(x)), rtol=0, atol=ATOL)


def test_resume_recomputes_crc_corrupt_region(tmp_path):
    """Flipped bytes inside a committed tile region fail its CRC on
    resume, in both packages: the entry is dropped and the region
    recomputed, never trusted."""
    x = _x(40, 16, seed=11)
    baseline = _port(x)
    for port, name in ((False, "r.mm"), (True, "p.mm")):
        path, _, _ = _crash(tmp_path, name, 3, x, port=port)
        mm = np.memmap(path, dtype=np.float32, mode="r+", shape=(40, 40))
        mm[2, 3] += 1000.0   # committed pass 0: tile (0, 0)
        mm.flush()
        del mm
        got = _np(_port(x, resume_from=path))
        _same_bits(got, baseline)


def test_resume_trusts_intact_regions(tmp_path, monkeypatch):
    """Intact committed passes are never launched again, in either
    package: verification does not turn a resume into a recompute."""
    x = _x(33, 17, seed=12)
    rp, _, _ = _crash(tmp_path, "r.mm", 4, x, port=False)
    pp, _, _ = _crash(tmp_path, "p.mm", 4, x, port=True)
    spies = _Spies(monkeypatch)
    want = np.asarray(_ref(x, resume_from=rp))
    got = _np(_port(x, resume_from=pp))
    assert spies.port == spies.ref == [8, 12]  # passes 0-1 committed
    _same_bits(got, _port(x))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_resume_refuses_garbled_sidecar(tmp_path):
    x = _x(40, 16, seed=13)
    for port, name in ((False, "r.mm"), (True, "p.mm")):
        path, _, _ = _crash(tmp_path, name, 3, x, port=port)
        with open(path + ".progress.json", "w") as f:
            f.write('{"version": 2, "entries"')
        with pytest.raises(ValueError, match="unreadable|garbled"):
            _port(x, resume_from=path)
        with pytest.raises(ValueError, match="unreadable|garbled"):
            _ref(x, resume_from=path)


def _ref_indices(key: int, iterations: int, l: int) -> np.ndarray:
    """The reference's permutation rows of RefSpec(iterations, key)."""
    import jax
    from repro.core import significance as ref_significance
    keys = ref_significance.iteration_keys(RefSpec(iterations=iterations,
                                                   key=key))
    rows = jax.vmap(lambda k: jax.random.permutation(k, l))(keys)
    return np.asarray(rows, dtype=np.int64)


def test_pvalue_checkpoint_crash_and_resume(tmp_path, monkeypatch):
    """Kill-and-resume of the significance run's checkpointed p-value leg
    (ExceedanceSink over HostSink): the crash at the sidecar commit fires
    on the reference's arrival, the resume launches replicas only for the
    passes the sidecar lacks, and p is bitwise the uninterrupted run's
    (the port fed the reference's permutations) and the reference's."""
    from repro_torch.core import significance
    x = _x(40, 16, seed=16)
    idx = torch.from_numpy(_ref_indices(15, 6, 16))

    def ref_spec(sink=None):
        return RefSpec(iterations=6, key=15, chunk=4, sink=sink)

    def spec(sink=None):
        return PermutationSpec(iterations=6, indices=idx, chunk=4, sink=sink)

    _, rp_full = _ref(x, pvalues=ref_spec())
    _, p_full = _port(x, pvalues=spec())
    ref_plan, plan = _plans(("sink_commit", "crash", (3,)))
    with ref_plan.armed(), pytest.raises(ref_faults.CrashFault):
        _ref(x, pvalues=ref_spec(RefHostSink(path=str(tmp_path / "r.mm"))))
    with plan.armed(), pytest.raises(CrashFault):
        _port(x, pvalues=spec(HostSink(path=str(tmp_path / "p.mm"))))
    assert plan.fired == ref_plan.fired
    for name in ("r.mm", "p.mm"):
        prog = json.loads((tmp_path / f"{name}.progress.json").read_text())
        assert prog["completed"] == 0  # the crash killed pass 1's commit
    replicas = []
    real = significance.pcc_tiles

    def spy(u, j0, **k):
        replicas.append(k["v_pad"] is not None and k["v_pad"].dim() == 3)
        return real(u, j0, **k)

    monkeypatch.setattr(significance, "pcc_tiles", spy)
    _, p_res = _port(x, pvalues=spec(HostSink(path=str(tmp_path / "p.mm"),
                                              resume=True)))
    # r (DenseSink) reruns all 4 passes; p only passes 1-3, 2 chunks each
    assert replicas.count(False) == 4 and replicas.count(True) == 6
    _same_bits(p_res, p_full)
    _, rp_res = _ref(x, pvalues=ref_spec(RefHostSink(
        path=str(tmp_path / "r.mm"), resume=True)))
    iu = np.triu_indices(40)
    np.testing.assert_array_equal(np.asarray(rp_res)[iu],
                                  np.asarray(rp_full)[iu])
    np.testing.assert_array_equal(p_res[iu], np.asarray(rp_full)[iu])


def test_topk_rerun_under_faults_stays_exact():
    """TopKSink's merge is not idempotent under duplicates: passes
    relaunched after a transient fault and an out-of-memory error must
    not merge candidates twice."""
    x = _x(40, 16, seed=17)
    base = _port(x, sink=TopKSink(5))
    want, got, _ = _run_both(
        [("pass_launch", "transient", (2,)), ("pass_launch", "oom", (5,))],
        x, ref_kw=dict(sink=RefTopKSink(5)), port_kw=dict(sink=TopKSink(5)))
    _same_topk(got, base)
    np.testing.assert_array_equal(got["indices"], np.asarray(
        want["indices"]))
    np.testing.assert_allclose(got["values"], np.asarray(want["values"]),
                               rtol=0, atol=ATOL)


# -- the acceptance scenario and seeded chaos ------------------------------------------


def test_device_loss_then_crash_mid_checkpoint_then_resume(tmp_path):
    """One FaultPlan loses the device mid-run (recovered in-process, the
    sidecar rewritten under the rebound plan) and crashes the process
    mid-checkpoint (recovered by restart and resume): bitwise the
    fault-free run, in both packages alike."""
    x = _x(40, 16, seed=14)
    baseline = _port(x)
    specs = [("pass_launch", "device_loss", (2,)),
             ("sink_commit", "crash", (4,))]
    ref_plan, plan = _plans(*specs)
    ref_pol = ref_faults.RetryPolicy(sleep=lambda s: None,
                                     on_device_loss=_ref_repartition)
    pol = RetryPolicy(sleep=lambda s: None, on_device_loss=_keep_plan)
    rp, pp = str(tmp_path / "r.mm"), str(tmp_path / "p.mm")
    with ref_plan.armed(), pytest.raises(ref_faults.CrashFault):
        _ref(x, sink=RefHostSink(path=rp), recovery=ref_pol)
    with plan.armed(), pytest.raises(CrashFault):
        _port(x, sink=HostSink(path=pp), recovery=pol)
    _same_recovery(ref_plan, plan, ref_pol, pol)
    assert [e["action"] for e in pol.log] == ["shrink_mesh", "raise"]
    assert [f[2] for f in plan.fired] == ["device_loss", "crash"]
    # the same sidecar but for the CRCs (the packages' float32 sums differ
    # in the last bits)
    sides = [json.loads(open(p + ".progress.json").read()) for p in (rp, pp)]
    for side in sides:
        for e in side["entries"]:
            e.pop("crc")
    assert sides[0] == sides[1]
    got = _port(x, resume_from=pp, recovery=_policies()[1])
    _same_bits(got, baseline)
    np.testing.assert_allclose(_np(got), np.asarray(_ref(
        x, resume_from=rp, recovery=_policies()[0])), rtol=0, atol=ATOL)


def test_seeded_scenario_completes_and_replays(tmp_path):
    """Seeded chaos: the run completes bitwise, the same seed fires the
    same faults again, and both packages fire the same ones."""
    x = _x(40, 16, seed=15)
    baseline = _port(x)
    fired = []
    for i in range(2):
        plan = FaultPlan.scenario(21, sites=("pass_launch", "sink_write"),
                                  rate=0.3, horizon=12)
        pol = RetryPolicy(sleep=lambda s: None, max_retries=6)
        with plan.armed():
            r = _port(x, sink=HostSink(path=str(tmp_path / f"p{i}.mm")),
                      recovery=pol)
        _same_bits(r, baseline)
        fired.append(tuple(plan.fired))
    ref_plan = ref_faults.FaultPlan.scenario(
        21, sites=("pass_launch", "sink_write"), rate=0.3, horizon=12)
    ref_pol = ref_faults.RetryPolicy(sleep=lambda s: None, max_retries=6)
    with ref_plan.armed():
        want = _ref(x, sink=RefHostSink(path=str(tmp_path / "r.mm")),
                    recovery=ref_pol)
    assert fired[0] == fired[1] == tuple(ref_plan.fired)
    assert len(fired[0]) > 0 and pol.log == ref_pol.log
    np.testing.assert_allclose(r, np.asarray(want), rtol=0, atol=ATOL)


# -- every measure, operand type and sink the executor runs -------------------------

# case -> (measure, compute_dtype, l, rectangular, reference tolerance)
RECOVERY_CASES = {
    "pearson": ("pearson", None, 16, False, ATOL),
    "spearman": ("spearman", None, 16, True, ATOL),
    "cosine": ("cosine", None, 16, False, ATOL),
    "covariance": ("covariance", None, 16, True, ATOL),
    # l = 15, not 16: a dot operand needing no padding is the caller's own
    # array, and the reference's TransformCache then deadlocks in
    # clear_prepared_cache() (ROADMAP C2)
    "dot": ("dot", None, 15, False, ATOL),
    "kendall_sign_gemm": ("kendall", None, 12, False, ATOL),
    "kendall_merge": ("kendall_merge", None, 12, False, ATOL),
    "kendall_tau_b_merge": ("kendall_tau_b_merge", None, 12, True, 1e-6),
    "bfloat16": ("pearson", "bfloat16", 16, False, 1e-5),
    "float16": ("pearson", "float16", 16, True, 1e-5),
    "int8_kendall": ("kendall", "int8", 12, True, ATOL),
    "int16_kendall": ("kendall", "int16", 12, False, ATOL),
    "int8_quantized": ("pearson", "int8", 16, True, ATOL),
    "float8_e4m3fn": ("pearson", "float8_e4m3fn", 16, False, ATOL),
}


@pytest.mark.parametrize("case", list(RECOVERY_CASES))
def test_recovery_runs_every_measure_and_operand_type(case):
    """corr(recovery=) on symmetric and rectangular plans of every measure
    and stored type: the same faults and log as the reference, the port's
    result bitwise its fault-free run and within the slice's parity
    tolerance of the reference's."""
    measure, cd, l, rect, tol = RECOVERY_CASES[case]
    # scaled by 1 / sqrt(l): dot and covariance stay O(1), as ATOL assumes
    x = _x(40, l, seed=30) / np.float32(np.sqrt(l))
    y = _x(19, l, seed=31) / np.float32(np.sqrt(l)) if rect else None
    baseline = _port(x, y, measure=measure, compute_dtype=cd)
    specs = [("pass_launch", "transient", (2,)), ("pass_launch", "oom", (4,))]
    # the reference takes these two as jnp dtypes
    ref_cd = {"float16": jnp.float16, "int16": jnp.int16}.get(cd, cd)
    want, got, pol = _run_both(specs, x, y, measure=measure,
                               port_kw=dict(compute_dtype=cd),
                               ref_kw=dict(compute_dtype=ref_cd))
    assert [e["action"] for e in pol.log] == ["retry", "shrink_pass"]
    _same_bits(got, baseline)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=tol)


@pytest.mark.parametrize("sink", ["edges", "reduction", "row_blocks",
                                  "host_out"])
def test_recovery_with_the_streaming_sinks(sink):
    """The sinks whose merge is not idempotent get each tile once: the
    recovered result equals the fault-free one exactly."""
    x = _x(40, 16, seed=32)
    y = _x(30, 16, seed=33) if sink == "row_blocks" else None

    def make():
        if sink == "edges":
            return EdgeCountSink(0.3, labels=np.arange(40) % 3)
        if sink == "reduction":
            return ReductionSink(lambda s, ids, tiles, ys, xs, plan:
                                 s + int((np.abs(tiles) >= 0.3).sum()), 0)
        if sink == "row_blocks":
            return RowBlockSink([(0, 13), (13, 40)])
        return HostSink(out=np.zeros((40, 40), np.float32))

    base = _port(x, y, sink=make())
    plan = FaultPlan([FaultSpec("pass_launch", "transient", (2,)),
                      FaultSpec("pass_launch", "oom", (4,))])
    pol = RetryPolicy(sleep=lambda s: None)
    with plan.armed():
        got = _port(x, y, sink=make(), recovery=pol)
    assert [e["action"] for e in pol.log] == ["retry", "shrink_pass"]
    if sink == "edges":
        assert got["edges"] == base["edges"]
        assert got["intra_edges"] == base["intra_edges"]
        np.testing.assert_array_equal(got["degrees"], base["degrees"])
    elif sink == "row_blocks":
        for a, b in zip(got, base):
            _same_bits(a, b)
    elif sink == "reduction":
        assert got == base   # an integer count: every tile folded once
    else:
        _same_bits(got, base)


def test_execute_plan_recovery_on_a_prepared_plan():
    """execute_plan(recovery=) on a hand-built plan: the executor's own
    entry point, symmetric and rectangular."""
    x, y = _x(40, 16, seed=34), _x(27, 16, seed=35)
    for n_cols in (None, 27):
        plan = ExecutionPlan.create(40, 16, n_cols=n_cols, **KW)
        if n_cols is None:
            ops = (plan.prepare(torch.from_numpy(x)),)
        else:
            ops = plan.prepare_pair(torch.from_numpy(x), torch.from_numpy(y))
        base = execute_plan(plan, *ops, device="cpu")
        fp = FaultPlan.single("pass_launch", "transient", at=3)
        pol = RetryPolicy(sleep=lambda s: None)
        with fp.armed():
            got = execute_plan(plan, *ops, device="cpu", recovery=pol)
        _same_bits(got, base)
        assert [e["action"] for e in pol.log] == ["retry"]
