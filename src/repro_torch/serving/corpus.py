"""CorpusHandle: a registered expression corpus, transformed once.

Port of ``repro/serving/corpus.py``.  The serving workload is "m probes
against the corpus": which of n corpus genes co-express with a handful of
probes (the rectangular grid workload of core/api.py).  The corpus side is
fixed, an (n, l) matrix registered once, so its per-measure row transform
(the only per-operand device work of a run) is computed once and reused by
every query.

A ``CorpusHandle`` keeps the corpus tensor on the device and owns a private
:class:`~repro_torch.core.api.TransformCache`, the seam ``corr()`` routes
its operands through, keyed per (measure, compute_dtype, alignment).
``operand()`` returns the prepared operand the batcher hands the executor
as ``v_pad``; ``row_norms()`` the per-row L2 norms of the transformed
corpus (degenerate rows transform to zero rows).

Corpora are live: ``append(rows)`` and ``update(idx, rows)`` mutate the
corpus.  Moment-form measures (pearson, cosine, covariance, dot) maintain
their prepared operands incrementally (serving/live.py) within a
``drift_budget`` of update batches; rank measures (spearman, kendall*)
warn once per measure and re-transform the full corpus exactly on next use.
Every mutation builds a new corpus tensor (``torch.cat`` for an append, an
out-of-place ``index_copy`` for an update), never writes the old one (a
batch in flight on the server's dispatcher thread may still read it), bumps
the ``generation`` and pushes a :class:`~repro_torch.serving.live.Delta`
to subscribers on the mutating thread.  The new tensor is a new cache key;
the old tensor's entries die with it.

Streams: a transform or an incremental step queues on the current CUDA
stream of the thread that runs it, and the server's dispatcher thread
reads the operand on its own current stream.  Both are the device's
default stream (neither thread selects another), so the reads are ordered
after the writes without an event; :class:`~repro_torch.core.sinks.
PassStream`'s side stream only ever reads finished tiles.
"""

from __future__ import annotations

import threading
import warnings
from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.core import measures
from repro_torch.core.allpairs import resolve_device
from repro_torch.core.api import TransformCache
from repro_torch.core.plan import prepare_operand_raw, resolve_compute_dtype
from repro_torch.core.quantize import operand_data
from repro_torch.core.significance import indices_fingerprint, \
    replica_operand
from repro_torch.kernels.pcc_tile import DEFAULT_LBLK, DEFAULT_TILE, \
    dtype_name
from repro_torch.serving.live import DEFAULT_DRIFT_BUDGET, Delta, \
    IncrementalOperand, supports_incremental


def _owned(x, dev: torch.device) -> torch.Tensor:
    """A copy of x on dev that the handle owns.  The corpus changes only
    through append / update, which build new tensors; a caller writing its
    own tensor or numpy array afterwards changes nothing here (a CPU
    tensor made from numpy would share the array's memory).  The copy is
    a normal tensor even when x is an inference tensor, which has no
    version counter, so the transform cache can hold its operands."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    with torch.inference_mode(False):
        return x.to(dev, copy=True)


class CorpusHandle:
    """An (n, l) corpus registered with the serving layer.

    Holds its own copy of the corpus on ``device`` (None means "cuda", or
    the card a CUDA tensor lies on; tests pass "cpu") and the cached
    per-measure prepared operands.  Mutations (``append`` / ``update`` /
    ``refresh``) serialise on an internal lock and run subscriber
    revalidation before returning; reads (``operand`` / ``row_norms``) are
    lock-free snapshots.
    """

    def __init__(self, x, *, t: int = DEFAULT_TILE,
                 l_blk: int = DEFAULT_LBLK, cache_capacity: int = 8,
                 drift_budget: int = DEFAULT_DRIFT_BUDGET, device=None):
        dev = (x.device if device is None and isinstance(x, torch.Tensor)
               and x.device.type == "cuda" else resolve_device(device))
        x = _owned(x, dev)
        if x.ndim != 2:
            raise ValueError(
                f"corpus must be (n, l), got shape {tuple(x.shape)}")
        if drift_budget < 1:
            raise ValueError(f"drift_budget must be >= 1, got {drift_budget}")
        self.x = x
        self.t = int(t)
        self.l_blk = int(l_blk)
        self.drift_budget = int(drift_budget)
        self._cache = TransformCache(capacity=cache_capacity)
        self._norms: Dict[str, torch.Tensor] = {}
        self._null_chunks: Dict[tuple, object] = {}
        # -- live-corpus state --
        self._mu = threading.Lock()          # serialises mutations
        self._generation = 0
        self._live: Dict[tuple, IncrementalOperand] = {}
        self._served_exact: Dict[tuple, str] = {}   # key -> measure name
        self._warned: set = set()
        self._subscribers: Dict[int, Callable[[Delta], None]] = {}
        self._next_sub = 0
        self.refreshes = 0

    @property
    def device(self) -> torch.device:
        return self.x.device

    @property
    def n(self) -> int:
        return self.x.shape[0]

    @property
    def l(self) -> int:
        return self.x.shape[1]

    @property
    def generation(self) -> int:
        """Corpus version: 0 at registration, +1 per append / update batch.
        Served results name the generation they answered against."""
        return self._generation

    def _prepare(self, meas: measures.Measure, compute_dtype):
        # the one shared preparation pipeline (plan.prepare_operand_raw):
        # serving bit-identity needs exactly what corr() prepares
        return prepare_operand_raw(self.x, meas, compute_dtype, self.t,
                                   self.l_blk)

    def operand(self, measure: measures.MeasureLike = "pearson",
                compute_dtype=None):
        """The prepared corpus operand of a measure (transformed, maybe
        narrowed or quantized, padded), computed at most once per (measure,
        compute_dtype) and kept on the device; bitwise what
        ``corr(probes, corpus, measure=...)`` prepares.  Moment-form
        measures keep it current across mutations incrementally (within the
        drift budget); rank measures rebuild it exactly after each."""
        meas = measures.get(measure)
        cd = resolve_compute_dtype(meas, compute_dtype)
        key = (meas.name, None if cd is None else dtype_name(cd))
        if supports_incremental(meas, cd):
            state = self._live.get(key)
            if state is None:
                state = IncrementalOperand(self.x, meas, cd, self.t,
                                           self.l_blk,
                                           operand=self._prepare(meas, cd))
                self._live[key] = state
            # the maintained operand re-enters through the TransformCache,
            # so hit / miss accounting (corr()'s shared seam) keeps working;
            # a miss after a mutation hands back the maintained operand and
            # runs no transform
            return self._cache.prepared(self.x, meas, cd, self.t,
                                        self.l_blk,
                                        build=lambda: state.operand)
        self._served_exact[key] = meas.name
        return self._cache.prepared(self.x, meas, cd, self.t, self.l_blk,
                                    build=lambda: self._prepare(meas, cd))

    # -- mutation -----------------------------------------------------------------

    def _warn_exact_fallbacks(self) -> None:
        for name in set(self._served_exact.values()):
            if name not in self._warned:
                self._warned.add(name)
                warnings.warn(
                    f"corpus mutation with measure {name!r}: rank "
                    f"transforms have no incremental (moment) form, so "
                    f"the full corpus re-transforms exactly on next use "
                    f"(O(n*l), never silently stale). Expect mutation-"
                    f"heavy workloads on rank measures to pay cold-"
                    f"transform cost per batch.", stacklevel=3)

    def _maintain(self, apply_delta: Callable[[IncrementalOperand], None],
                  new_x: torch.Tensor) -> None:
        """Advance every maintained operand, then enforce the drift budget:
        a state that has absorbed ``drift_budget`` moment-merged update
        batches rebuilds exactly from the new corpus."""
        for state in list(self._live.values()):
            apply_delta(state)
            if state.update_batches >= self.drift_budget:
                state.refresh(new_x)
                self.refreshes += 1

    def _finish_mutation(self, new_x: torch.Tensor, delta_kind: str,
                         **kw) -> Delta:
        self._warn_exact_fallbacks()
        self.x = new_x          # a new tensor: the old entries die with it
        self._norms.clear()
        self._null_chunks.clear()
        self._generation += 1
        delta = Delta(self._generation, delta_kind, **kw)
        errs = []
        for fn in list(self._subscribers.values()):
            try:
                fn(delta)
            except Exception as e:          # noqa: BLE001 — isolate subs
                errs.append(e)
        if errs:
            raise errs[0]
        return delta

    def _check_rows(self, rows) -> torch.Tensor:
        rows = torch.as_tensor(rows)
        if rows.ndim != 2 or rows.shape[1] != self.l:
            raise ValueError(
                f"mutation rows must be (d, {self.l}), got "
                f"{tuple(rows.shape)}")
        if rows.shape[0] == 0:
            raise ValueError("mutation batch is empty")
        return rows.to(self.x.device, self.x.dtype)

    def append(self, rows) -> Delta:
        """Append d fresh rows.  Maintained operands extend in O(d l) (batch
        moment seed and the moment-form transform of the new rows alone);
        subscribers revalidate before this returns.  Returns the
        :class:`Delta` with the new generation."""
        rows = self._check_rows(rows)
        with self._mu:
            n0 = self.n
            new_x = torch.cat([self.x, rows])
            self._maintain(lambda st: st.append(rows), new_x)
            return self._finish_mutation(new_x, "append",
                                         lo=n0, hi=n0 + rows.shape[0])

    def update(self, idx, rows) -> Delta:
        """Replace the rows at ``idx`` (unique, in range) with ``rows``.
        Maintained operands advance by the Welford delta merge of the
        affected rows' moments, O(d l), counted against the drift budget."""
        rows = self._check_rows(rows)
        idx = np.asarray(idx, np.int64).reshape(-1)
        if idx.size != rows.shape[0]:
            raise ValueError(
                f"idx has {idx.size} entries for {rows.shape[0]} rows")
        if idx.size != np.unique(idx).size:
            raise ValueError("update indices must be unique")
        if idx.size and (idx.min() < 0 or idx.max() >= self.n):
            raise ValueError(
                f"update indices out of range for n={self.n}")
        with self._mu:
            ji = torch.as_tensor(idx, device=self.x.device)
            old_rows = self.x[ji]
            new_x = self.x.index_copy(0, ji, rows)
            self._maintain(lambda st: st.update(idx, old_rows, rows), new_x)
            return self._finish_mutation(new_x, "update", idx=idx)

    def refresh(self) -> None:
        """Rebuild every maintained operand exactly now (what the drift
        budget does periodically): afterwards each is bitwise a cold
        transform of the current corpus.  The generation does not move (the
        corpus values do not); standing indexes repair their merged state
        with their own ``rebuild()``."""
        with self._mu:
            for state in list(self._live.values()):
                state.refresh(self.x)
                self.refreshes += 1
            # self.x keeps its identity and version here, so the cached
            # entries would be stale: drop them, and the next operand()
            # re-enters the rebuilt state
            self._cache.clear()

    def subscribe(self, fn: Callable[[Delta], None]) -> Callable[[], None]:
        """Register a delta subscriber (a standing index or a server
        watch): ``fn(delta)`` runs on the mutating thread after the corpus
        has advanced.  Returns an unsubscribe callable."""
        with self._mu:
            sid = self._next_sub
            self._next_sub += 1
            self._subscribers[sid] = fn

        def unsubscribe() -> None:
            with self._mu:
                self._subscribers.pop(sid, None)

        return unsubscribe

    # -- derived state --------------------------------------------------------------

    def row_norms(self, measure: measures.MeasureLike = "pearson"
                  ) -> torch.Tensor:
        """Per-row L2 norms of the transformed corpus (cached).  Pearson,
        spearman and cosine rows are unit-norm except degenerate (constant
        or all-zero) rows, which are exactly 0."""
        meas = measures.get(measure)
        norms = self._norms.get(meas.name)
        if norms is None:
            u = operand_data(self.operand(meas))[: self.n].to(torch.float32)
            norms = torch.sqrt((u * u).sum(dim=1))
            self._norms[meas.name] = norms
        return norms

    def replica_source_for(self, plan, spec):
        """A caching replica source for significance queries against this
        corpus: its null state.

        ``run_significance`` (core/significance.py) builds each replica
        chunk's stacked permuted-corpus operand per pass; for a served
        corpus that stack depends only on the measure, dtype, method, B,
        chunking and the chunk's index rows, so every query of the same
        null reuses the stacks the first built.  Returns a
        ``replica_source(chunk_index, index_rows)`` callable for
        ``run_significance(replica_source=)``; entries are keyed by the
        chunk index and ``indices_fingerprint`` of its index rows (the
        reference keys them by its jax key) and live until a mutation or
        ``clear_null_state()``: B x the corpus operand of device memory
        when fully built.  Two threads missing the same chunk build
        identical stacks."""
        cd = (None if plan.compute_dtype is None
              else dtype_name(plan.compute_dtype))
        base = (plan.measure.name, cd, spec.method, spec.iterations,
                plan.replica_chunk)

        def source(ci: int, idx_c: torch.Tensor):
            cache_key = base + (ci, indices_fingerprint(idx_c))
            stack = self._null_chunks.get(cache_key)
            if stack is None:
                stack = replica_operand(
                    plan, idx_c, method=spec.method, columns=self.x,
                    cols_prepared=self.operand(plan.measure,
                                               plan.compute_dtype))
                self._null_chunks[cache_key] = stack
            return stack

        return source

    def clear_null_state(self) -> None:
        """Drop every cached replica-chunk stack (memory pressure)."""
        self._null_chunks.clear()

    def stats(self) -> dict:
        """Transform-cache counters: ``misses`` is the number of corpus
        transforms run (one per (measure, dtype), however many queries
        arrive), except that a maintained operand re-enters the cache after
        a mutation as a miss that runs no transform.  ``null_chunks``
        counts the cached replica-chunk stacks.  Live state rides along:
        generation, per-state drift counters, refreshes, subscribers."""
        out = self._cache.stats()
        out["null_chunks"] = len(self._null_chunks)
        out["generation"] = self._generation
        out["rows"] = self.n
        out["drift_budget"] = self.drift_budget
        out["refreshes"] = self.refreshes
        out["subscribers"] = len(self._subscribers)
        out["live"] = {"/".join(str(p) for p in key): st.stats()
                       for key, st in self._live.items()}
        return out

    def __repr__(self) -> str:
        return (f"CorpusHandle(n={self.n}, l={self.l}, t={self.t}, "
                f"l_blk={self.l_blk}, gen={self._generation}, "
                f"cached={len(self._cache)}, device={self.device})")


def as_corpus(corpus, *, t: int = DEFAULT_TILE, l_blk: int = DEFAULT_LBLK,
              device=None) -> CorpusHandle:
    """An array, tensor or handle as a CorpusHandle (arrays register fresh
    on ``device``; handles pass through, their alignment must match)."""
    if isinstance(corpus, CorpusHandle):
        if (corpus.t, corpus.l_blk) != (t, l_blk):
            raise ValueError(
                f"corpus handle alignment (t={corpus.t}, l_blk="
                f"{corpus.l_blk}) does not match requested (t={t}, "
                f"l_blk={l_blk})")
        return corpus
    if isinstance(corpus, (np.ndarray, torch.Tensor)) or hasattr(
            corpus, "__array__"):
        return CorpusHandle(corpus, t=t, l_blk=l_blk, device=device)
    raise TypeError(f"cannot register corpus of type {type(corpus)}")


__all__ = ["CorpusHandle", "as_corpus"]
