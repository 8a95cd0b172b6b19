"""Deterministic fault injection and the failure taxonomy recovery acts on.

Port of ``repro/runtime/faults.py``.  Two things make recovery drivable and
testable:

1. A **deterministic fault-injection harness**.  A :class:`FaultPlan` arms
   named failure points ("sites"):

     ``pass_launch``      kernel launches of one executor pass
                          (core/allpairs.py, core/significance.py)
     ``sink_write``       a tile write into a sink's storage (partial
                          writes: some tiles land, then the fault raises;
                          core/sinks.py HostSink, ShardedHostSink)
     ``sink_flush``       the durable flush of written tiles
     ``sink_commit``      the checkpoint commit (before the atomic rename)
     ``server_dispatch``  one coalesced batch dispatch (serving/server.py)

   each raising a typed :class:`InjectedFault` at exact per-site *arrival
   counts*, so a test replays a precise sequence ("the second pass launch
   raises a transient error"), and :meth:`FaultPlan.scenario` draws
   reproducible random chaos from a seed.  Every site sits where the
   reference's does, so equal plans fire on equal arrivals in both
   packages.

2. The **failure taxonomy** (:func:`classify_failure`) and the
   :class:`RetryPolicy` that a recovering caller acts on:

     transient    retry in place with exponential backoff
     oom          shrink the pass (halve max_tiles_per_pass) and retry
     device_loss  continue on the survivors (``on_device_loss``; one
                  device has none, so by default the loss propagates)
     crash        a simulated process death (CrashFault): never handled
                  in-process; recovery is restart + ``resume_from=``
     fatal        everything else: real bugs propagate

Injected faults are control-flow only: they corrupt no state, they make the
site fail as its real counterpart would.  ``classify_failure`` maps the real
failures of this package onto the same taxonomy: ``torch.cuda``'s
out-of-memory error, and the CUDA runtime's error strings as PyTorch and
the kernel launchers (``... launch failed: <cudaGetErrorString>``) raise
them.  An error that poisons the CUDA context (an illegal address, a
device-side assert) is never transient: every later call in the process
fails too.  Arming is process-global (``with plan.armed(): ...``) so worker
threads, the CorrServer dispatcher among them, see the same plan; the
counters are lock-protected.  With no plan armed a site check is one None
test.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

SITES = ("pass_launch", "sink_write", "sink_flush", "sink_commit",
         "server_dispatch")


# -- typed faults ---------------------------------------------------------------


class InjectedFault(Exception):
    """Base of every injected failure: ``site`` and the 1-based ``arrival``
    count at that site it fired on."""

    kind = "fatal"

    def __init__(self, site: str, arrival: int, detail: str = ""):
        self.site = site
        self.arrival = arrival
        super().__init__(
            f"injected {self.kind} fault at {site!r} (arrival {arrival})"
            + (f": {detail}" if detail else ""))


class TransientFault(InjectedFault):
    """A transient runtime error: the operation succeeds if retried."""

    kind = "transient"


class DeviceLostFault(InjectedFault):
    """A lost device: it never comes back; recovery continues on the
    survivors."""

    kind = "device_loss"


class OomFault(InjectedFault):
    """A device out-of-memory error at launch: the same launch at a smaller
    pass can succeed."""

    kind = "oom"


class SinkIOFault(InjectedFault, OSError):
    """An I/O error in a sink's write or flush path (disk full, a stale
    network handle): transient from the executor's point of view."""

    kind = "transient"


class PartialWriteFault(SinkIOFault):
    """An I/O error midway through a tile batch: the sink writes
    ``fraction`` of the batch, then raises this, so a partially written
    pass must never be marked complete."""

    def __init__(self, site: str, arrival: int, fraction: float = 0.5):
        self.fraction = float(fraction)
        super().__init__(site, arrival, f"partial write ({fraction:.0%})")


class CrashFault(InjectedFault):
    """A simulated process death: classified "crash", which no in-process
    recovery handles; the harness catches it at the top and restarts."""

    kind = "crash"


FAULT_KINDS = {
    "transient": TransientFault,
    "device_loss": DeviceLostFault,
    "oom": OomFault,
    "io": SinkIOFault,
    "partial_write": PartialWriteFault,
    "crash": CrashFault,
}


# -- FaultPlan: armed sites, exact arrival triggers -----------------------------


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Fire one fault kind at exact arrival counts of one site.

    at: 1-based arrival numbers that raise (``(2, 3)``: the second and third
        time execution reaches the site).  An armed site counts every
        arrival, so a retried operation advances the count, and ``(1, 2)``
        means "fail twice, then succeed".
    fraction: for ``partial_write``, the share of the batch written before
        the fault raises.
    """

    site: str
    kind: str
    at: Tuple[int, ...]
    fraction: float = 0.5

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"sites: {SITES}")
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"kinds: {tuple(FAULT_KINDS)}")
        object.__setattr__(self, "at", tuple(int(a) for a in self.at))
        if any(a <= 0 for a in self.at):
            raise ValueError(f"arrival numbers are 1-based, got {self.at}")


class FaultPlan:
    """A deterministic schedule of injected faults over named sites.

    Built from :class:`FaultSpec`s for exact replay, or by :meth:`scenario`
    for seeded random chaos.  Thread-safe: the arrival counters and the
    ``fired`` log, every fault raised as ``(site, arrival, kind)``, are
    lock-protected.
    """

    def __init__(self, specs: Sequence[FaultSpec] = ()):
        self.specs = tuple(specs)
        self._lock = threading.Lock()
        self._arrivals = {s: 0 for s in SITES}
        self.fired: List[Tuple[str, int, str]] = []

    @classmethod
    def single(cls, site: str, kind: str, at: int = 1,
               times: int = 1, fraction: float = 0.5) -> "FaultPlan":
        """One fault kind at one site, on `times` consecutive arrivals from
        the `at`-th on."""
        return cls([FaultSpec(site, kind, tuple(range(at, at + times)),
                              fraction=fraction)])

    @classmethod
    def scenario(cls, seed: int, *, sites: Sequence[str] = SITES,
                 kinds: Sequence[str] = ("transient", "io"),
                 rate: float = 0.15, horizon: int = 40) -> "FaultPlan":
        """Seeded random chaos: each of the first `horizon` arrivals at each
        site fires, with probability `rate`, a kind drawn from `kinds`.  The
        same seed gives the same schedule (numpy's default_rng, as in the
        reference, so both packages draw the same one)."""
        rng = np.random.default_rng(seed)
        specs = []
        for site in sites:
            hits = rng.random(horizon) < rate
            draws = rng.integers(0, len(kinds), horizon)
            for i in np.nonzero(hits)[0]:
                specs.append(FaultSpec(site, kinds[int(draws[i])],
                                       (int(i) + 1,)))
        return cls(specs)

    def arrivals(self, site: str) -> int:
        with self._lock:
            return self._arrivals[site]

    def poll(self, site: str) -> Optional[InjectedFault]:
        """Count one arrival at `site`; return the fault armed for this
        arrival (logged in ``fired``), or None."""
        with self._lock:
            self._arrivals[site] += 1
            n = self._arrivals[site]
            for spec in self.specs:
                if spec.site == site and n in spec.at:
                    self.fired.append((site, n, spec.kind))
                    klass = FAULT_KINDS[spec.kind]
                    if klass is PartialWriteFault:
                        return klass(site, n, spec.fraction)
                    return klass(site, n)
        return None

    @contextlib.contextmanager
    def armed(self):
        """Install this plan as the process-wide active plan."""
        global _ACTIVE
        prev = _ACTIVE
        _ACTIVE = self
        try:
            yield self
        finally:
            _ACTIVE = prev


_ACTIVE: Optional[FaultPlan] = None


def active_plan() -> Optional[FaultPlan]:
    return _ACTIVE


def poll(site: str) -> Optional[InjectedFault]:
    """The site entry point for sites that act on the fault before raising
    (partial writes).  No plan armed: None."""
    plan = _ACTIVE
    return None if plan is None else plan.poll(site)


def check(site: str) -> None:
    """The site entry point: raise the fault armed for this arrival, if
    any.  One None test when nothing is armed."""
    fault = poll(site)
    if fault is not None:
        raise fault


# -- failure taxonomy -------------------------------------------------------------

# CUDA runtime messages (cudaGetErrorString) as PyTorch ("CUDA error: ...")
# and the kernel launchers ("<kernel> launch failed: ...") raise them.
# Errors that poison the CUDA context: every later call in the process
# fails, so none of them is ever retried; they are bugs or broken hardware,
# and propagate as fatal.
_STICKY_TOKENS = ("illegal memory access", "illegal address",
                  "illegal instruction", "misaligned address",
                  "device-side assert", "unspecified launch failure",
                  "launch timed out", "hardware stack error",
                  "invalid program counter")
_OOM_TOKENS = ("out of memory", "CUBLAS_STATUS_ALLOC_FAILED")
_DEVICE_LOSS_TOKENS = ("uncorrectable ECC error", "no CUDA-capable device",
                       "fallen off the bus", "GPU is lost", "device lost")
_TRANSIENT_TOKENS = ("busy or unavailable", "Connection reset",
                     "Socket closed")
# what a runtime error from this package's device work says about itself
_RUNTIME_MARKS = ("CUDA error", "launch failed:", "CUDA out of memory",
                  "cuTensorMapEncodeTiled", "CUBLAS_STATUS")


def classify_failure(exc: BaseException) -> str:
    """Map a failure onto the recovery taxonomy: "transient" | "oom" |
    "device_loss" | "crash" | "fatal".

    Injected faults classify by type.  ``torch.cuda.OutOfMemoryError`` is
    "oom".  A RuntimeError from the CUDA runtime or a kernel launcher
    (PyTorch's "CUDA error: ..." messages, this package's "... launch
    failed: ..." ones) classifies by its cudaGetErrorString text, as the
    reference reads XLA status prefixes: a context-poisoning (sticky) error
    is "fatal" before anything else is considered, then out of memory,
    device loss and the transient family.  Anything unrecognised is fatal:
    recovery never papers over a real bug.
    """
    if isinstance(exc, CrashFault):
        return "crash"
    if isinstance(exc, DeviceLostFault):
        return "device_loss"
    if isinstance(exc, OomFault):
        return "oom"
    if isinstance(exc, (TransientFault, SinkIOFault)):
        return "transient"
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return "oom"
    if isinstance(exc, RuntimeError):
        msg = str(exc)
        if not any(mark in msg for mark in _RUNTIME_MARKS):
            return "fatal"
        if any(tok in msg for tok in _STICKY_TOKENS):
            return "fatal"
        if any(tok in msg for tok in _OOM_TOKENS):
            return "oom"
        if any(tok in msg for tok in _DEVICE_LOSS_TOKENS):
            return "device_loss"
        if any(tok in msg for tok in _TRANSIENT_TOKENS):
            return "transient"
    return "fatal"


# -- RetryPolicy ------------------------------------------------------------------


@dataclasses.dataclass
class RetryPolicy:
    """What a recovering caller does per taxonomy class
    (``core/allpairs.execute_plan(recovery=...)``, ``corr(recovery=)``,
    ``LiveIndex(recovery=)``; the degrading CorrServer).

    max_retries:     transient failures tolerated without forward progress
                     (the budget refills whenever a pass lands).
    backoff_s / backoff_factor / max_backoff_s: exponential backoff between
                     transient retries; ``sleep`` is injectable so tests run
                     at full speed.
    shrink_on_device_loss: continue on the survivors (False: fatal).
    shrink_pass_on_oom: halve max_tiles_per_pass and retry, never below one
                     tile a pass (False: fatal).
    on_device_loss:  override of the survivor resolution,
                     ``(mesh, plan, exc) -> (new_mesh, new_plan)``.
    log:             recovery events as dicts ({"kind", "action", ...}).
    """

    max_retries: int = 3
    backoff_s: float = 0.02
    backoff_factor: float = 2.0
    max_backoff_s: float = 1.0
    shrink_on_device_loss: bool = True
    shrink_pass_on_oom: bool = True
    sleep: Callable[[float], None] = time.sleep
    on_device_loss: Optional[Callable] = None
    log: List[dict] = dataclasses.field(default_factory=list)

    def backoff(self, attempt: int) -> float:
        """Backoff before the `attempt`-th consecutive retry (0-based)."""
        return min(self.backoff_s * self.backoff_factor ** attempt,
                   self.max_backoff_s)


__all__ = [
    "SITES",
    "FAULT_KINDS",
    "InjectedFault",
    "TransientFault",
    "DeviceLostFault",
    "OomFault",
    "SinkIOFault",
    "PartialWriteFault",
    "CrashFault",
    "FaultSpec",
    "FaultPlan",
    "active_plan",
    "poll",
    "check",
    "classify_failure",
    "RetryPolicy",
]
