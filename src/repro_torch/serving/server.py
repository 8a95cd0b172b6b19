"""CorrServer: a long-lived query service over registered corpora.

Port of ``repro/serving/server.py``.  A server owns

  * one or more :class:`~repro_torch.serving.corpus.CorpusHandle`\\ s (corpus
    transforms run once per measure, kept on the card), routed by corpus
    id: the constructor's corpus registers as ``"default"``,
    ``add_corpus()`` registers more, and ``submit(..., corpus=...)`` routes
    each request;
  * ONE shared :class:`~repro_torch.serving.plan_cache.PlanCache`;
  * a :class:`~repro_torch.serving.batcher.QueryBatcher` per corpus and ONE
    dispatcher thread that coalesces concurrent requests under a max-wait /
    max-batch-rows policy (requests against different corpora share a
    coalescing window, never a launch).

Submission is thread-safe from any number of caller threads:

    with CorrServer(corpus, t=..., max_wait_s=0.002) as srv:
        fut = srv.submit(probes, k=10)        # async: Future[ServedResult]
        res = srv.query(other_probes)         # sync: ServedResult

``submit()`` validates and enqueues and returns a Future at once; the
dispatcher collects what arrives within ``max_wait_s`` of the oldest queued
request (or until ``max_batch_rows`` probe rows wait) and serves the batch
with the fewest launches.  Every launch, transform and result copy of a
batch happens on the dispatcher thread.

Threads, devices and streams.  The dispatcher thread makes the default
corpus's card its current device before it serves anything.  PyTorch's
current stream is per thread, and every thread here (callers, the
dispatcher, a mutating thread) leaves it at the device's default stream,
so a corpus transform queued on one thread and read by a batch on another
are ordered on that one stream, without an event; the sinks' side stream
(core/sinks.PassStream) waits on each pass's own event.  An exception on
the dispatcher thread always reaches the futures of the batch it was
serving, never only a log.

Every result carries per-request stats: queue wait, service time, batch
occupancy, whether the launch hit the plan cache, and the corpus generation
it answered against.

Standing queries: ``watch(probes, k)`` registers a :class:`WatchHandle`, a
top-k query kept current as its corpus mutates: each delta revalidates it
incrementally (probes against the delta rows only, merged in the canonical
top-k order; probe rows whose kept set referenced a revised column
recompute exactly), and a changed kept set is pushed to the watch's
callback.  Revalidation runs on the dispatcher thread: the corpus
subscriber only enqueues, so a slow callback never stalls ingest; deltas
apply in generation order and ``flush_watches()`` waits for them.

Degradation: malformed probes are refused at submit() (shape, dtype,
finiteness).  A failed batch is retried once when the failure is transient
(runtime/faults.classify_failure), then split: each request re-runs in its
own launch, so only the request that fails gets its error.  Per-request
deadlines fail expired requests with :class:`DeadlineExceeded` before a
launch is spent on them.  A circuit breaker counts consecutive failed
dispatches; past ``breaker_threshold`` it opens for
``breaker_cooldown_s`` and submit() sheds load with
:class:`ServerOverloaded`.  All of it shows in ``stats()["faults"]``.  The
fault site ``server_dispatch`` (runtime/faults.py) is checked before each
dispatch attempt.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import measures
from repro_torch.core.allpairs import execute_plan
from repro_torch.core.plan import ExecutionPlan, prepare_operand_raw, \
    take_operand_rows
from repro_torch.core.significance import PermutationSpec, run_significance
from repro_torch.core.sinks import DenseSink, topk_merge_rows
from repro_torch.kernels.pcc_tile import DEFAULT_LBLK, DEFAULT_TILE
from repro_torch.runtime import faults
from repro_torch.serving.batcher import Query, QueryBatcher
from repro_torch.serving.live import Delta, host_array, topk_rows_from_dense
from repro_torch.serving.plan_cache import PlanCache, ProblemSpec

DEFAULT_CORPUS = "default"


class DeadlineExceeded(TimeoutError):
    """The request's deadline passed before it was served.  Raised through
    the Future: an expired request is shed at dispatch, its launch never
    run, so a backlog drains at queue speed once deadlines lapse."""


class ServerOverloaded(RuntimeError):
    """Fast-fail shed: the circuit breaker is open after consecutive failed
    dispatches.  Raised by ``submit()`` so callers back off instead of
    queueing onto a backend that fails every launch."""


@dataclasses.dataclass
class ServedResult:
    """A request's answer and how it was served.

    value: the dense (m, n) host float32 rows or the {"indices", "values"}
           top-k dict, bitwise a standalone ``corr()`` call's.
    stats: queue_s (enqueue -> dispatch), service_s (dispatch -> done),
           batch_requests / batch_rows / batch_occupancy, plan_cache_hit,
           passes, corpus (id) and corpus_generation.
    """

    value: Any
    stats: dict


@dataclasses.dataclass
class _Pending:
    query: Query
    future: Future
    t_enqueue: float
    deadline: Optional[float] = None    # absolute time.monotonic() cutoff
    corpus_id: str = DEFAULT_CORPUS


class WatchHandle:
    """A standing top-k query: ``probes`` against a live corpus, kept
    current.

    Registered by :meth:`CorrServer.watch` (deltas then apply on the
    server's dispatcher thread, in generation order) or built standalone
    (deltas apply on the mutating thread).  Either way each delta
    revalidates it incrementally:

      append(d)  launches only the probes against the d new rows and merges
                 the candidates in the canonical top-k order;
      update(d)  launches the probes against the d revised rows; probe rows
                 whose kept set referenced a revised column recompute
                 exactly, the others merge the revised values.

    The probes are prepared once (the shape a standalone ``corr(probes,
    corpus)`` transforms) and every launch takes rows of that operand, so
    a full revalidation is bitwise the cold top-k.  A changed kept set is
    pushed to ``callback(snapshot)``; ``current()`` returns the standing
    snapshot; both name the corpus generation they reflect.
    """

    def __init__(self, batcher: QueryBatcher, probes, k: int,
                 meas: measures.Measure,
                 callback: Optional[Callable[[dict], None]] = None,
                 corpus_id: str = DEFAULT_CORPUS,
                 dispatch: Optional[Callable[["WatchHandle", Delta],
                                             None]] = None):
        q = Query(probes, k=k, measure=meas)    # eager probe validation
        if q.probes.shape[1] != batcher.corpus.l:
            raise ValueError(
                f"probes have l={q.probes.shape[1]} samples, corpus "
                f"{corpus_id!r} has l={batcher.corpus.l}")
        self.batcher = batcher
        self.corpus_id = corpus_id
        self.probes = q.probes.to(batcher.corpus.device)
        self.m = q.m
        self.k = int(k)
        self.meas = meas
        self.callback = callback
        self.pushes = 0             # callback deliveries (kept set changed)
        self.revalidations = 0      # deltas examined
        self._u = None              # the prepared probes, made once
        self._lock = threading.Lock()
        with self._lock:
            self._refresh_full()
        # With a dispatch hook (CorrServer.watch) the corpus subscriber only
        # enqueues: the launches and the user's callback run on the
        # dispatcher thread, so a watch never stalls the mutating thread.
        # Standalone handles revalidate before the mutation returns.
        if dispatch is None:
            self._unsubscribe = batcher.corpus.subscribe(self._on_delta)
        else:
            self._unsubscribe = batcher.corpus.subscribe(
                lambda delta: dispatch(self, delta))
        self._closed = False

    # -- delta-plan launches -------------------------------------------------------

    def _spec(self, rows: int, cols: int) -> ProblemSpec:
        b = self.batcher
        return ProblemSpec.for_query(
            rows, cols, b.corpus.l, measure=self.meas, t=b.t, l_blk=b.l_blk,
            compute_dtype=b.compute_dtype, clip=b.clip,
            fuse_epilogue=b.fuse_epilogue,
            max_tiles_per_pass=b.max_tiles_per_pass, mesh=b.mesh)

    def _block(self, probe_rows, col_sel, n_cols: int) -> np.ndarray:
        """Dense scores of (some of) the probes against a column selection
        of the corpus operand: one bucketed grid launch through the shared
        plan cache."""
        b = self.batcher
        dev = b.corpus.device
        m = self.m if probe_rows is None else len(probe_rows)
        plan, _ = b.plan_cache.get(self._spec(m, n_cols))
        if self._u is None:
            self._u = prepare_operand_raw(self.probes, plan.measure,
                                          plan.compute_dtype, b.t, b.l_blk)
        rows = (slice(0, self.m) if probe_rows is None else
                torch.as_tensor(np.asarray(probe_rows, np.int64), device=dev))
        u = take_operand_rows(self._u, rows, plan.n_pad)
        v_full = b.corpus.operand(plan.measure, plan.compute_dtype)
        if col_sel is None:
            col_sel = slice(0, plan.col_pad)
        # slice, then pad: the tail of a live operand holds real appended
        # rows, so delta columns re-pad with zeros
        v = take_operand_rows(v_full, col_sel, plan.col_pad)
        r = execute_plan(plan, u, v, sink=DenseSink(), device=dev,
                         mesh=b.mesh)
        return host_array(r)[:m]

    # -- revalidation ----------------------------------------------------------------

    def _refresh_full(self) -> None:
        n = self.batcher.corpus.n
        r = self._block(None, None, n)
        self._vals, self._idx = topk_rows_from_dense(r, self.k)
        self._generation = self.batcher.corpus.generation

    def _apply_append(self, delta: Delta) -> None:
        n0, d = delta.lo, delta.hi - delta.lo
        block = self._block(None, slice(n0, delta.hi), d)   # (m, d)
        r_ids = np.repeat(np.arange(self.m, dtype=np.int64), d)
        c_ids = np.tile(np.arange(n0, delta.hi, dtype=np.int64), self.m)
        topk_merge_rows(self._vals, self._idx, r_ids, c_ids,
                        block.reshape(-1), self.k)

    def _apply_update(self, delta: Delta) -> None:
        idx = np.asarray(delta.idx, np.int64)
        n = self.batcher.corpus.n
        block = self._block(None, torch.as_tensor(
            idx, device=self.batcher.corpus.device), idx.size)  # (m, d)
        updated = np.zeros(n, bool)
        updated[idx] = True
        stale_mask = (updated[np.clip(self._idx, 0, n - 1)]
                      & (self._idx >= 0)).any(axis=1)
        stale = np.where(stale_mask)[0]
        if stale.size:
            # a kept value may have dropped: recompute those probe rows
            r = self._block(stale, None, n)
            self._vals[stale], self._idx[stale] = topk_rows_from_dense(
                r, self.k)
        rest = np.where(~stale_mask)[0]
        if rest.size:
            r_ids = np.repeat(rest, idx.size)
            c_ids = np.tile(idx, rest.size)
            v = block[rest].reshape(-1)
            topk_merge_rows(self._vals, self._idx, r_ids, c_ids, v, self.k)

    def _on_delta(self, delta: Delta) -> None:
        snap = None
        with self._lock:
            before_v, before_i = self._vals.copy(), self._idx.copy()
            if delta.generation != self._generation + 1:
                self._refresh_full()        # missed a delta: resync exactly
            elif delta.kind == "append":
                self._apply_append(delta)
            else:
                self._apply_update(delta)
            self._generation = delta.generation
            self.revalidations += 1
            changed = not (np.array_equal(before_i, self._idx)
                           and np.array_equal(before_v, self._vals))
            if changed:
                self.pushes += 1
                snap = self._snapshot()
        if snap is not None and self.callback is not None:
            self.callback(snap)     # outside the lock: callbacks may read

    # -- results -----------------------------------------------------------------------

    def _snapshot(self) -> dict:
        vals = self._vals.copy()
        vals[self._idx < 0] = 0.0
        return {"indices": self._idx.copy(), "values": vals,
                "generation": self._generation, "corpus": self.corpus_id}

    @property
    def generation(self) -> int:
        return self._generation

    def current(self) -> dict:
        """The standing result: {"indices", "values", "generation",
        "corpus"}, the top-k answer as of the named generation."""
        with self._lock:
            return self._snapshot()

    def close(self) -> None:
        """Stop revalidating (the last snapshot stays readable)."""
        if not self._closed:
            self._closed = True
            self._unsubscribe()


class CorrServer:
    """Plan-cached, request-batched ``corr()`` queries against corpora.

    max_wait_s:     how long the dispatcher holds the oldest request open
                    for batch-mates before launching.
    max_batch_rows: flush as soon as this many probe rows are queued; a
                    batch never exceeds it unless a single request does
                    (requests are never split across launches).
    deadline_s:     default per-request deadline (None: none); expired
                    requests fail with DeadlineExceeded instead of taking
                    a launch.  submit(deadline_s=) overrides per request.
    breaker_threshold / breaker_cooldown_s: after `threshold` consecutive
                    failed dispatches the breaker opens and submit() sheds
                    load with ServerOverloaded for `cooldown` seconds; one
                    successful dispatch closes it.
    device:         where a corpus given as an array lives (None means
                    "cuda"; tests pass "cpu"); a CorpusHandle keeps its own.
    mesh:           a launch.mesh.Mesh every launch runs over (the corpora
                    on its first device); stats()["host_occupancy"] then
                    holds each rank's mean tile occupancy.
    The other keywords keep their ``corr()`` meaning and fix the serving
    configuration of every registered corpus.
    """

    def __init__(self, corpus, *,
                 measure: measures.MeasureLike = "pearson",
                 t: int = DEFAULT_TILE, l_blk: int = DEFAULT_LBLK,
                 max_wait_s: float = 0.002, max_batch_rows: int = 4096,
                 deadline_s: Optional[float] = None,
                 breaker_threshold: int = 5,
                 breaker_cooldown_s: float = 1.0,
                 plan_cache: Optional[PlanCache] = None,
                 compute_dtype=None, clip: bool = True,
                 fuse_epilogue: bool = True,
                 max_tiles_per_pass: Optional[int] = None, mesh=None,
                 device=None):
        if max_wait_s < 0:
            raise ValueError(f"max_wait_s must be >= 0, got {max_wait_s}")
        if max_batch_rows <= 0:
            raise ValueError(
                f"max_batch_rows must be positive, got {max_batch_rows}")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s must be positive, got {deadline_s}")
        if breaker_threshold <= 0:
            raise ValueError(
                f"breaker_threshold must be positive, got {breaker_threshold}")
        # one plan cache for every corpus: equal specs share frozen plans
        plan_cache = plan_cache if plan_cache is not None else PlanCache()
        self._cfg = dict(
            measure=measure, plan_cache=plan_cache, t=t, l_blk=l_blk,
            compute_dtype=compute_dtype, clip=clip,
            fuse_epilogue=fuse_epilogue,
            max_tiles_per_pass=max_tiles_per_pass, mesh=mesh, device=device)
        self.batcher = QueryBatcher(corpus, **self._cfg)
        self._batchers: Dict[str, QueryBatcher] = {
            DEFAULT_CORPUS: self.batcher}
        self.max_wait_s = float(max_wait_s)
        self.max_batch_rows = int(max_batch_rows)
        self.deadline_s = None if deadline_s is None else float(deadline_s)
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self._cv = threading.Condition()
        self._queue: List[_Pending] = []
        self._watches: List[WatchHandle] = []
        # watch deltas enqueued by mutating threads, drained (FIFO) by the
        # dispatcher ahead of each batch; _deltas_busy covers the window
        # between popping and applying, so flush_watches() cannot return
        # while a revalidation is in flight
        self._deltas: List[tuple] = []
        self._deltas_busy = False
        self._closed = False
        self._batches = 0
        self._requests = 0
        self._rows = 0
        self._occupancy_sum = 0.0
        self._host_occ_sums: Optional[List[float]] = None
        self._host_occ_batches = 0
        # degradation state (all under _cv): consecutive failed dispatches
        # drive the breaker; the counters feed stats()["faults"]
        self._consecutive_failures = 0
        self._breaker_open_until = 0.0
        self._fault_counts = {
            "batch_failures": 0,    # dispatches whose first attempt failed
            "retries": 0,           # transient-classified in-place retries
            "splits": 0,            # batches re-run request by request
            "failed_requests": 0,   # futures resolved with an error
            "deadline_exceeded": 0,  # requests shed past their deadline
            "shed": 0,              # submits refused while the breaker is open
            "breaker_trips": 0,     # closed -> open transitions
            "watch_errors": 0,      # watch revalidations / callbacks raised
        }
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        name="corr-server-dispatch",
                                        daemon=True)
        self._thread.start()

    # -- corpora ------------------------------------------------------------------------

    @property
    def corpus(self):
        return self.batcher.corpus

    @property
    def plan_cache(self) -> PlanCache:
        return self.batcher.plan_cache

    def _batcher(self, corpus_id: str) -> QueryBatcher:
        b = self._batchers.get(corpus_id)
        if b is None:
            raise ValueError(
                f"unknown corpus {corpus_id!r}; registered: "
                f"{sorted(self._batchers)}")
        return b

    def add_corpus(self, name: str, corpus):
        """Register another corpus under ``name``; later
        ``submit(..., corpus=name)`` / ``watch(..., corpus=name)`` route to
        it.  It shares the server's plan cache and serving configuration.
        Returns the registered CorpusHandle."""
        if name == DEFAULT_CORPUS and corpus is not self.corpus:
            raise ValueError(
                f"{DEFAULT_CORPUS!r} is the constructor corpus's id")
        with self._cv:
            if self._closed:
                raise RuntimeError("CorrServer is closed")
            if name in self._batchers:
                raise ValueError(f"corpus {name!r} is already registered")
            b = QueryBatcher(corpus, **self._cfg)
            self._batchers[name] = b
        return b.corpus

    def corpora(self) -> List[str]:
        """Registered corpus ids (routing keys for submit / query / watch)."""
        with self._cv:
            return sorted(self._batchers)

    # -- submission ---------------------------------------------------------------------

    def submit(self, probes, *, k: Optional[int] = None,
               measure: Optional[measures.MeasureLike] = None,
               deadline_s: Optional[float] = None,
               corpus: str = DEFAULT_CORPUS) -> "Future[ServedResult]":
        """Enqueue one query; returns at once with a Future of its
        :class:`ServedResult`.

        Raises ValueError for malformed probes (rank, a non-real dtype,
        NaN / Inf) and unknown corpus ids, and :class:`ServerOverloaded`
        while the breaker is open.  A sample-count mismatch against the
        routed corpus fails the Future at dispatch (the split isolates it
        from batch-mates).  Past ``deadline_s`` (default: the server's) the
        Future fails with :class:`DeadlineExceeded` instead of running."""
        q = Query(probes, k=k, measure=measure)  # validates probes eagerly
        self._batcher(corpus)                    # routing must resolve now
        if deadline_s is None:
            deadline_s = self.deadline_s
        elif deadline_s <= 0:
            raise ValueError(f"deadline_s must be positive, got {deadline_s}")
        fut: Future = Future()
        now = time.monotonic()
        with self._cv:
            if self._closed:
                raise RuntimeError("CorrServer is closed")
            if now < self._breaker_open_until:
                self._fault_counts["shed"] += 1
                raise ServerOverloaded(
                    f"circuit breaker open after "
                    f"{self._consecutive_failures} consecutive dispatch "
                    f"failures; retry after "
                    f"{self._breaker_open_until - now:.3f}s")
            deadline = None if deadline_s is None else now + deadline_s
            self._queue.append(_Pending(q, fut, now, deadline, corpus))
            self._cv.notify_all()
        return fut

    def query(self, probes, *, k: Optional[int] = None,
              measure: Optional[measures.MeasureLike] = None,
              deadline_s: Optional[float] = None,
              corpus: str = DEFAULT_CORPUS,
              timeout: Optional[float] = None) -> ServedResult:
        """The synchronous spelling of submit(): blocks for the result (the
        request still rides whatever batch the dispatcher forms).
        ``timeout`` bounds the wait (None: none)."""
        return self.submit(probes, k=k, measure=measure,
                           deadline_s=deadline_s,
                           corpus=corpus).result(timeout)

    def watch(self, probes, k: int, callback=None, *,
              measure: Optional[measures.MeasureLike] = None,
              corpus: str = DEFAULT_CORPUS) -> WatchHandle:
        """Register a standing top-k query (see :class:`WatchHandle`).  The
        first snapshot is computed now, on the caller's thread; every later
        delta is enqueued to the dispatcher thread and applied in
        generation order (``flush_watches()`` waits for them).
        ``callback(snapshot)`` fires whenever the kept set changes.
        Unregister with ``unwatch(handle)`` or ``handle.close()``."""
        b = self._batcher(corpus)
        meas = b.measure if measure is None else measures.get(measure)
        h = WatchHandle(b, probes, k, meas, callback, corpus_id=corpus,
                        dispatch=self._enqueue_delta)
        with self._cv:
            if self._closed:
                h.close()
                raise RuntimeError("CorrServer is closed")
            self._watches.append(h)
        return h

    def _enqueue_delta(self, handle: WatchHandle, delta) -> None:
        """The corpus subscriber of server watches: O(1) on the mutating
        thread; the revalidation launch runs on the dispatcher."""
        with self._cv:
            if self._closed:
                return
            self._deltas.append((handle, delta))
            self._cv.notify_all()

    def flush_watches(self, timeout: Optional[float] = None) -> None:
        """Block until every watch delta enqueued so far has been applied
        (mutate, flush, then ``current()`` reads the post-delta answer)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self._deltas or self._deltas_busy:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        f"{len(self._deltas)} watch deltas still pending "
                        f"after {timeout}s")
                self._cv.wait(remaining)

    def unwatch(self, handle: WatchHandle) -> None:
        """Stop a standing query (idempotent)."""
        handle.close()
        with self._cv:
            if handle in self._watches:
                self._watches.remove(handle)

    def significance(self, probes, *, pvalues: PermutationSpec,
                     measure: Optional[measures.MeasureLike] = None,
                     corpus: str = DEFAULT_CORPUS) -> ServedResult:
        """"Is this edge real?": probe rows against the corpus with
        permutation (or bootstrap) p-values.  The value is ``(r, p)``, both
        (m, n) on the corpus's device, bitwise what
        ``corr(probes, corpus_tensor, pvalues=...)`` returns.

        Runs on the caller's thread, past the batcher: a B-replica sweep is
        far heavier than the dense queries the dispatcher coalesces.  It
        shares the corpus state: the cached corpus transform and the
        corpus's cached null state
        (:meth:`~repro_torch.serving.corpus.CorpusHandle.replica_source_for`),
        so a repeat query of the same PermutationSpec reuses the stacked
        permuted-corpus operands (``null_state_hit``)."""
        b = self._batcher(corpus)
        meas = b.measure if measure is None else measures.get(measure)
        dev = b.corpus.device
        probes = torch.as_tensor(probes if isinstance(probes, torch.Tensor)
                                 else np.asarray(probes), device=dev)
        if probes.ndim != 2 or probes.shape[1] != b.corpus.l:
            raise ValueError(
                f"probes must be (m, l={b.corpus.l}), got shape "
                f"{tuple(probes.shape)}")
        plan = ExecutionPlan.create(
            probes.shape[0], b.corpus.l, n_cols=b.corpus.n,
            t=b.t, l_blk=b.l_blk, measure=meas,
            p=1 if b.mesh is None else b.mesh.size,
            max_tiles_per_pass=b.max_tiles_per_pass, clip=b.clip,
            fuse_epilogue=b.fuse_epilogue, compute_dtype=b.compute_dtype,
            replicas=pvalues.iterations, replica_chunk=pvalues.chunk)
        t_start = time.monotonic()
        null_before = b.corpus.stats()["null_chunks"]
        r, pv = run_significance(
            plan, pvalues, plan.prepare(probes), columns=b.corpus.x,
            v_pad=b.corpus.operand(plan.measure, plan.compute_dtype),
            mesh=b.mesh,
            replica_source=b.corpus.replica_source_for(plan, pvalues))
        stats = {
            "service_s": time.monotonic() - t_start,
            "iterations": pvalues.iterations,
            "replica_chunks": len(plan.replica_chunk_sizes),
            "null_state_hit": (b.corpus.stats()["null_chunks"]
                               == null_before),
            "passes": plan.n_pass,
            "corpus": corpus,
            "corpus_generation": b.corpus.generation,
        }
        return ServedResult(value=(r, pv), stats=stats)

    # -- dispatcher ---------------------------------------------------------------------

    def _take_batch(self) -> List[_Pending]:
        """The next batch (called with _cv held, the queue non-empty): wait
        out the oldest request's max_wait_s window (flushing early on
        max_batch_rows), then pop whole requests FIFO up to the row cap."""
        deadline = self._queue[0].t_enqueue + self.max_wait_s
        while not self._closed:
            rows = sum(p.query.m for p in self._queue)
            remaining = deadline - time.monotonic()
            if rows >= self.max_batch_rows or remaining <= 0:
                break
            self._cv.wait(timeout=remaining)
        batch, rows = [], 0
        while self._queue:
            nxt = self._queue[0]
            if batch and rows + nxt.query.m > self.max_batch_rows:
                break
            batch.append(self._queue.pop(0))
            rows += nxt.query.m
        return batch

    def _dispatch_loop(self) -> None:
        dev = self.corpus.device
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        while True:
            with self._cv:
                while (not self._queue and not self._deltas
                       and not self._closed):
                    self._cv.wait()
                deltas, self._deltas = self._deltas, []
                if deltas:
                    self._deltas_busy = True
                if not deltas and not self._queue and self._closed:
                    return
                batch = self._take_batch() if self._queue else []
            # watch deltas first: they were enqueued before (or while) the
            # batch coalesced, and FIFO keeps each corpus's generation
            # order.  Errors are counted, never raised: a broken callback
            # must not stop the dispatcher.
            for h, d in deltas:
                try:
                    if not getattr(h, "_closed", False):
                        h._on_delta(d)
                except Exception:       # noqa: BLE001 — isolate watches
                    with self._cv:
                        self._fault_counts["watch_errors"] += 1
            if deltas:
                with self._cv:
                    self._deltas_busy = False
                    self._cv.notify_all()
            if batch:
                try:
                    self._serve(batch)
                except BaseException as e:  # noqa: BLE001 — to the futures
                    # _serve resolves every future itself; anything that
                    # escapes it still reaches the requests it was serving
                    for p in batch:
                        if not p.future.done():
                            p.future.set_exception(e)

    def _execute_batch(self, batcher: QueryBatcher, queries: List[Query]):
        """One dispatch attempt, retried in place once when the failure is
        transient (runtime/faults taxonomy): a blip should not cost a whole
        split."""
        try:
            faults.check("server_dispatch")
            return batcher.execute(queries)
        except BaseException as e:  # noqa: BLE001 — classified below
            if faults.classify_failure(e) != "transient":
                raise
            with self._cv:
                self._fault_counts["retries"] += 1
        faults.check("server_dispatch")
        return batcher.execute(queries)

    def _record_dispatch(self, ok: bool) -> None:
        """Breaker bookkeeping: success closes it, `breaker_threshold`
        consecutive failures open it for `breaker_cooldown_s`."""
        with self._cv:
            if ok:
                self._consecutive_failures = 0
                return
            self._fault_counts["batch_failures"] += 1
            self._consecutive_failures += 1
            if self._consecutive_failures >= self.breaker_threshold:
                self._fault_counts["breaker_trips"] += 1
                self._breaker_open_until = (time.monotonic()
                                            + self.breaker_cooldown_s)

    def _serve(self, batch: List[_Pending]) -> None:
        # Move every future to RUNNING first: from here on a client's
        # cancel() returns False instead of racing set_result.  Requests
        # cancelled before dispatch drop out uncomputed.
        batch = [p for p in batch if p.future.set_running_or_notify_cancel()]
        t_start = time.monotonic()
        # Deadline shed before the launch: an expired request must not
        # occupy batch rows.
        live = []
        for p in batch:
            if p.deadline is not None and t_start > p.deadline:
                with self._cv:
                    self._fault_counts["deadline_exceeded"] += 1
                    self._fault_counts["failed_requests"] += 1
                p.future.set_exception(DeadlineExceeded(
                    f"request waited {t_start - p.t_enqueue:.3f}s, past its "
                    f"{p.deadline - p.t_enqueue:.3f}s deadline"))
            else:
                live.append(p)
        if not live:
            return
        # Partition per corpus: requests against different corpora never
        # share a launch (different column operands).
        groups: Dict[str, List[_Pending]] = {}
        for p in live:
            groups.setdefault(p.corpus_id, []).append(p)
        for cid, grp in groups.items():
            self._serve_group(cid, grp, t_start)

    def _stats_of(self, p: _Pending, info, batcher: QueryBatcher,
                  t_start: float, t_done: float) -> dict:
        return {
            "queue_s": t_start - p.t_enqueue,
            "service_s": t_done - t_start,
            "batch_requests": info.requests,
            "batch_rows": info.rows,
            "batch_occupancy": info.occupancy,
            "plan_cache_hit": info.plan_cache_hit,
            "passes": info.passes,
            "corpus": p.corpus_id,
            "corpus_generation": batcher.corpus.generation,
        }

    def _serve_group(self, corpus_id: str, batch: List[_Pending],
                     t_start: float) -> None:
        batcher = self._batchers[corpus_id]
        try:
            results, infos = self._execute_batch(
                batcher, [p.query for p in batch])
        except BaseException as e:  # noqa: BLE001 — degrade, don't die
            self._record_dispatch(ok=False)
            if len(batch) == 1:
                # nothing left to isolate (the transient retry already ran
                # inside _execute_batch): the request is at fault
                with self._cv:
                    self._fault_counts["failed_requests"] += 1
                batch[0].future.set_exception(e)
                return
            # SPLIT: each request in its own launch, so only the requests
            # that fail get their error
            with self._cv:
                self._fault_counts["splits"] += 1
            for p in batch:
                self._serve_one(batcher, p, t_start)
            return
        self._record_dispatch(ok=True)
        t_done = time.monotonic()
        with self._cv:
            self._batches += 1
            self._requests += len(batch)
            self._rows += sum(p.query.m for p in batch)
            self._occupancy_sum += sum(i.occupancy for i in infos
                                       ) / max(len(infos), 1)
            self._accum_host_occ(infos)
        for p, value, info in zip(batch, results, infos):
            p.future.set_result(ServedResult(
                value=value,
                stats=self._stats_of(p, info, batcher, t_start, t_done)))

    def _serve_one(self, batcher: QueryBatcher, p: _Pending,
                   t_start: float) -> None:
        """Serve one request of a split batch in its own launch."""
        try:
            results, infos = self._execute_batch(batcher, [p.query])
        except BaseException as e:  # noqa: BLE001 — this request's error
            self._record_dispatch(ok=False)
            with self._cv:
                self._fault_counts["failed_requests"] += 1
            p.future.set_exception(e)
            return
        self._record_dispatch(ok=True)
        t_done = time.monotonic()
        info = infos[0]
        with self._cv:
            self._batches += 1
            self._requests += 1
            self._rows += p.query.m
            self._occupancy_sum += info.occupancy
            self._accum_host_occ(infos)
        p.future.set_result(ServedResult(
            value=results[0],
            stats=self._stats_of(p, info, batcher, t_start, t_done)))

    # -- lifecycle / observability ------------------------------------------------------

    def _accum_host_occ(self, infos) -> None:
        """Fold each mesh launch's per-rank tile occupancy into the running
        per-rank sums (called with _cv held).  Requests of one launch share
        its BatchInfo, so each launch counts once."""
        for info in {id(i): i for i in infos}.values():
            ho = info.host_occupancy
            if ho is None:
                continue
            if (self._host_occ_sums is None
                    or len(self._host_occ_sums) != len(ho)):
                self._host_occ_sums = [0.0] * len(ho)
                self._host_occ_batches = 0
            self._host_occ_sums = [a + b for a, b in
                                   zip(self._host_occ_sums, ho)]
            self._host_occ_batches += 1

    def stats(self) -> dict:
        """Server counters and the plan- and transform-cache views.
        ``corpora`` maps every corpus id to its handle's stats; ``corpus``
        is the default corpus's; ``watches`` sums standing-query activity;
        ``host_occupancy`` is each mesh rank's mean tile occupancy over the
        mesh launches (None without a mesh, or before its first launch)."""
        with self._cv:
            batches = self._batches
            watches = list(self._watches)
            batchers = dict(self._batchers)
            served = {
                "requests": self._requests,
                "batches": batches,
                "rows": self._rows,
                "mean_batch_occupancy": (self._occupancy_sum / batches
                                         if batches else 0.0),
                "host_occupancy": (
                    None if not self._host_occ_batches else
                    [v / self._host_occ_batches
                     for v in self._host_occ_sums]),
                "queued": len(self._queue),
                "faults": {
                    **self._fault_counts,
                    "consecutive_failures": self._consecutive_failures,
                    "breaker_open": (time.monotonic()
                                     < self._breaker_open_until),
                },
            }
        served["plan_cache"] = self.plan_cache.stats()
        served["corpus"] = self.corpus.stats()
        served["corpora"] = {cid: b.corpus.stats()
                             for cid, b in batchers.items()}
        served["watches"] = {
            "count": len(watches),
            "revalidations": sum(w.revalidations for w in watches),
            "pushes": sum(w.pushes for w in watches),
        }
        return served

    def close(self, timeout: Optional[float] = None) -> None:
        """Drain the queue (every accepted Future resolves), stop the
        dispatcher and detach every standing query.  Idempotent."""
        with self._cv:
            self._closed = True
            watches = list(self._watches)
            self._cv.notify_all()
        self._thread.join(timeout)
        for w in watches:
            w.close()

    def __enter__(self) -> "CorrServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


__all__ = ["CorrServer", "DeadlineExceeded", "ServedResult",
           "ServerOverloaded", "WatchHandle"]
