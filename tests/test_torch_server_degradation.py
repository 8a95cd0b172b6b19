"""The port's CorrServer degrades instead of dying, case for case with
tests/test_server_degradation.py: poisoned probes are refused at submit(),
one failing request of a coalesced batch does not take down its
batch-mates (retry once, then split), expired requests fail with
DeadlineExceeded without a launch, and consecutive failed dispatches trip a
circuit breaker that sheds load with ServerOverloaded; all of it visible in
stats()["faults"], whose shape is the reference's.

Faults come from the port's runtime/faults FaultPlan at exact arrival
counts.  Where the reference's test relies on two submissions landing in
one batch within a wall-clock window (and races under parallel test
workers), these tests coalesce by row count instead: a long max_wait_s
and max_batch_rows equal to the requests' rows, so the batch goes out
exactly when every request is queued.  Every wait is bounded (<= 30 s) and
every server closes through a context manager.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.api import corr as ref_corr
from repro.runtime import faults as ref_faults
from repro.serving import CorrServer as RefCorrServer
from repro_torch.core import api
from repro_torch.core.api import corr
from repro_torch.runtime import faults
from repro_torch.runtime.faults import (CrashFault, FaultPlan, FaultSpec,
                                        classify_failure)
from repro_torch.serving import (CorrServer, DeadlineExceeded, Query,
                                 ServerOverloaded)

T, LBLK = 8, 8
WAIT = 30


def _x(n, l, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, l)).astype(np.float32)


@pytest.fixture
def corpus_x():
    return _x(40, 12, seed=100)


@pytest.fixture(autouse=True)
def _fresh_prepared_cache():
    api.clear_prepared_cache()
    yield
    api.clear_prepared_cache()


def _srv(corpus_x, **kw):
    kw.setdefault("t", T)
    kw.setdefault("l_blk", LBLK)
    return CorrServer(corpus_x, device="cpu", **kw)


def _want(probes, corpus_x):
    return corr(probes, corpus_x, t=T, l_blk=LBLK, device="cpu").numpy()


# -- validation at the door -----------------------------------------------------------


def test_poisoned_probe_rejected_at_submit(corpus_x):
    bad = np.ones((2, 12), np.float32)
    bad[1, 3] = np.nan
    with _srv(corpus_x) as srv:
        with pytest.raises(ValueError, match="non-finite"):
            srv.submit(bad)
        with pytest.raises(ValueError, match="non-finite"):
            srv.submit(torch.from_numpy(bad))
        with pytest.raises(ValueError, match="real-valued"):
            srv.submit(np.ones((2, 12), np.complex64))
        with pytest.raises(ValueError, match="real-valued"):
            srv.submit(torch.ones((2, 12), dtype=torch.complex64))
        good = _x(3, 12, seed=1)
        res = srv.query(good, timeout=WAIT)
        np.testing.assert_array_equal(res.value, _want(good, corpus_x))
        np.testing.assert_allclose(res.value, np.asarray(ref_corr(
            jnp.asarray(good), jnp.asarray(corpus_x), t=T, l_blk=LBLK)),
            rtol=0, atol=3e-6)
    assert srv.stats()["faults"]["failed_requests"] == 0


def test_query_validates_independently_of_server():
    with pytest.raises(ValueError, match="non-finite"):
        Query(np.array([[1.0, np.inf]], np.float32))


# -- retry once, then split ----------------------------------------------------------------


def test_transient_dispatch_fault_is_invisible(corpus_x):
    probes = _x(3, 12, seed=2)
    plan = FaultPlan.single("server_dispatch", "transient", at=1)
    with _srv(corpus_x) as srv, plan.armed():
        res = srv.query(probes, timeout=WAIT)
    np.testing.assert_array_equal(res.value, _want(probes, corpus_x))
    f = srv.stats()["faults"]
    assert f["retries"] == 1
    assert f["batch_failures"] == 0 and f["failed_requests"] == 0
    assert plan.fired == [("server_dispatch", 1, "transient")]


def test_batch_split_isolates_the_failing_request(corpus_x):
    """A non-transient failure of a coalesced batch re-runs request by
    request; only the request whose own launch fails gets the error.
    Arrivals: 1 = the coalesced batch, 2 = the first split request
    (fails), 3 = the second (succeeds).  The batch coalesces by rows
    (3 + 5 = max_batch_rows), not by a clock."""
    a, b = _x(3, 12, seed=3), _x(5, 12, seed=4)
    plan = FaultPlan([FaultSpec("server_dispatch", "crash", (1, 2))])
    with _srv(corpus_x, max_wait_s=WAIT, max_batch_rows=8) as srv, \
            plan.armed():
        fa = srv.submit(a)
        fb = srv.submit(b)
        with pytest.raises(CrashFault):
            fa.result(timeout=WAIT)
        res_b = fb.result(timeout=WAIT)
    np.testing.assert_array_equal(res_b.value, _want(b, corpus_x))
    assert res_b.stats["batch_requests"] == 1
    f = srv.stats()["faults"]
    assert f["splits"] == 1
    assert f["failed_requests"] == 1
    assert f["batch_failures"] == 2
    assert plan.arrivals("server_dispatch") == 3


def test_split_batch_results_stay_bit_identical(corpus_x):
    qs = [_x(m, 12, seed=10 + m) for m in (2, 3, 4)]
    plan = FaultPlan.single("server_dispatch", "crash", at=1)
    with _srv(corpus_x, max_wait_s=WAIT, max_batch_rows=9) as srv, \
            plan.armed():
        futs = [srv.submit(q) for q in qs]
        vals = [f.result(timeout=WAIT).value for f in futs]
    for q, v in zip(qs, vals):
        np.testing.assert_array_equal(v, _want(q, corpus_x))
    f = srv.stats()["faults"]
    assert f["failed_requests"] == 0 and f["splits"] == 1


# -- deadlines -------------------------------------------------------------------------------


def test_expired_deadline_fails_without_a_launch(corpus_x):
    """The dispatcher holds the batch for max_wait_s (0.15 s) after the
    oldest request, so a 1 ms deadline has always lapsed at dispatch."""
    with _srv(corpus_x, max_wait_s=0.15) as srv:
        doomed = srv.submit(_x(2, 12, seed=5), deadline_s=0.001)
        ok = srv.submit(_x(2, 12, seed=6))
        with pytest.raises(DeadlineExceeded):
            doomed.result(timeout=WAIT)
        ok.result(timeout=WAIT)
    f = srv.stats()["faults"]
    assert f["deadline_exceeded"] == 1 and f["failed_requests"] == 1
    assert srv.stats()["rows"] == 2     # the doomed rows never launched


def test_server_default_deadline_applies(corpus_x):
    with _srv(corpus_x, max_wait_s=0.15, deadline_s=0.001) as srv:
        with pytest.raises(DeadlineExceeded):
            srv.query(_x(2, 12, seed=7), timeout=WAIT)
        srv.query(_x(2, 12, seed=8), deadline_s=30.0, timeout=WAIT)
    assert srv.stats()["faults"]["deadline_exceeded"] == 1


def test_deadline_must_be_positive(corpus_x):
    with _srv(corpus_x) as srv:
        with pytest.raises(ValueError, match="deadline_s"):
            srv.submit(_x(2, 12, seed=9), deadline_s=0.0)
    with pytest.raises(ValueError, match="deadline_s"):
        _srv(corpus_x, deadline_s=-1.0)


# -- circuit breaker ---------------------------------------------------------------------


def test_breaker_opens_after_consecutive_failures_and_recloses(corpus_x):
    probes = _x(2, 12, seed=11)
    plan = FaultPlan.single("server_dispatch", "crash", at=1, times=2)
    cooldown = 2.0
    with _srv(corpus_x, breaker_threshold=2,
              breaker_cooldown_s=cooldown) as srv, plan.armed():
        for _ in range(2):
            with pytest.raises(CrashFault):
                srv.query(probes, timeout=WAIT)
        with pytest.raises(ServerOverloaded, match="circuit breaker"):
            srv.submit(probes)
        f = srv.stats()["faults"]
        assert f["breaker_open"] and f["breaker_trips"] == 1
        assert f["shed"] == 1 and f["consecutive_failures"] == 2
        time.sleep(cooldown + 0.1)
        res = srv.query(probes, timeout=WAIT)
    np.testing.assert_array_equal(res.value, _want(probes, corpus_x))
    f = srv.stats()["faults"]
    assert not f["breaker_open"] and f["consecutive_failures"] == 0


def test_breaker_threshold_validation(corpus_x):
    with pytest.raises(ValueError, match="breaker_threshold"):
        CorrServer(corpus_x, t=T, l_blk=LBLK, breaker_threshold=0,
                   device="cpu")


# -- observability --------------------------------------------------------------------------


def test_stats_faults_shape_when_healthy(corpus_x):
    with _srv(corpus_x) as srv:
        srv.query(_x(2, 12, seed=12), timeout=WAIT)
        f = srv.stats()["faults"]
    assert f == {"batch_failures": 0, "retries": 0, "splits": 0,
                 "failed_requests": 0, "deadline_exceeded": 0, "shed": 0,
                 "breaker_trips": 0, "watch_errors": 0,
                 "consecutive_failures": 0, "breaker_open": False}
    with RefCorrServer(jnp.asarray(corpus_x), t=T, l_blk=LBLK,
                       max_wait_s=0.0) as ref:
        ref.query(jnp.asarray(_x(2, 12, seed=12)))
        assert ref.stats()["faults"] == f
        assert set(ref.stats()) == set(srv.stats())


# -- the fault harness and the taxonomy -------------------------------------------------


def test_fault_plans_replay_the_reference_schedule():
    """The seeded scenario and the arrival counting are the reference's:
    the same seed draws the same schedule and fires at the same
    arrivals."""
    for seed in (0, 7):
        got = FaultPlan.scenario(seed)
        want = ref_faults.FaultPlan.scenario(seed)
        assert [(s.site, s.kind, s.at) for s in got.specs] == \
            [(s.site, s.kind, s.at) for s in want.specs]
    plan = FaultPlan.single("sink_write", "partial_write", at=2,
                            fraction=0.25)
    assert plan.poll("sink_write") is None
    fault = plan.poll("sink_write")
    assert isinstance(fault, faults.PartialWriteFault) and \
        fault.fraction == 0.25
    assert plan.fired == [("sink_write", 2, "partial_write")]
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultSpec("nope", "transient", (1,))
    with pytest.raises(ValueError, match="1-based"):
        FaultSpec("pass_launch", "transient", (0,))
    assert faults.active_plan() is None
    with plan.armed():
        assert faults.active_plan() is plan
    faults.check("pass_launch")      # nothing armed: no raise
    assert faults.RetryPolicy().backoff(10) == 1.0


@pytest.mark.parametrize("exc,kind", [
    (faults.TransientFault("server_dispatch", 1), "transient"),
    (faults.SinkIOFault("sink_write", 1), "transient"),
    (faults.OomFault("pass_launch", 1), "oom"),
    (faults.DeviceLostFault("pass_launch", 1), "device_loss"),
    (CrashFault("pass_launch", 1), "crash"),
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate"),
     "oom"),
    (RuntimeError("pcc_tiles launch failed: out of memory"), "oom"),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     "fatal"),
    (RuntimeError("pcc_topk_tiles (select) launch failed: device-side "
                  "assert triggered"), "fatal"),
    (RuntimeError("CUDA error: unspecified launch failure"), "fatal"),
    (RuntimeError("CUDA error: uncorrectable ECC error encountered"),
     "device_loss"),
    (RuntimeError("CUDA error: all CUDA-capable devices are busy or "
                  "unavailable"), "transient"),
    (RuntimeError("out of memory in my own code"), "fatal"),
    (ValueError("probes have l=11 samples"), "fatal"),
])
def test_classify_failure_maps_cuda_errors_onto_the_taxonomy(exc, kind):
    """The reference reads XLA status prefixes; the port reads
    torch.cuda.OutOfMemoryError and the CUDA runtime's error strings as
    PyTorch and the launchers raise them.  A context-poisoning error is
    never transient; anything not from the runtime is fatal."""
    assert classify_failure(exc) == kind
    if isinstance(exc, faults.InjectedFault):
        ref_cls = getattr(ref_faults, type(exc).__name__)
        assert ref_faults.classify_failure(ref_cls(exc.site, 1)) == kind
