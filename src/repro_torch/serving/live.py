"""Live corpora: incremental ingest, delta plans and standing state.

Port of ``repro/serving/live.py``.  Production corpora are not static:
rows arrive and get revised.  This module is the streaming side of the
serving layer:

  * **Incremental transform maintenance**: :class:`IncrementalOperand`
    keeps a (measure, dtype) prepared operand and the per-row running
    moments (mean, centered sum of squares M2) it derives from.  Append or
    update of d rows costs O(d l): fresh rows seed their moments with one
    batch pass, revised rows merge the delta into their moments and rebuild
    only their own operand rows through ``Measure.from_moments``.  The
    merge accumulates float32 drift, so each state counts its update
    batches against the corpus's drift budget and is rebuilt exactly
    (``refresh``) when it is spent; after a refresh the operand is bitwise
    a cold transform.  Rank measures (spearman, kendall*) have no moment
    form; the corpus re-transforms them exactly (serving/corpus.py).

  * **Delta-aware execution**: :class:`LiveIndex` keeps a standing
    corpus-vs-corpus result (dense matrix or per-row top-k) current.  On
    an append of d rows only the d-vs-n rectangular grid and the d-vs-d
    triangle launch, through tile-bucketed :class:`PlanCache` plans, never
    the full (n + d) triangle; the delta merges into the standing state,
    dense by row and column extension, top-k by the canonical per-row
    re-merge (:func:`~repro_torch.core.sinks.topk_merge_rows`).

  * **Versioned generations**: every mutation bumps the corpus generation,
    and every standing result and served answer names the generation it
    answered against.

Device work (the transforms, the delta launches) runs on the mutating
thread, on its current CUDA stream; the corpus serialises mutations.
``LiveIndex(recovery=RetryPolicy())`` arms the self-healing executor for
every launch of the index (the build and each delta's grid and triangle),
as in the reference; ``mesh=`` runs them over a mesh (the corpus on its
first device).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import measures
from repro_torch.core.allpairs import check_mesh, execute_plan
from repro_torch.core.plan import needs_row_scales, prepare_operand_raw, \
    take_operand_rows
from repro_torch.core.quantize import operand_data
from repro_torch.core.sinks import DenseSink, TopKSink, topk_merge_rows
from repro_torch.serving.plan_cache import PlanCache, ProblemSpec

# Incremental update batches an operand state may absorb before the next
# mutation forces an exact refresh (CorpusHandle(drift_budget=...)).
DEFAULT_DRIFT_BUDGET = 64

# Bound on |incremental - cold| for any result computed within one drift
# budget of moment-merged updates: the merge is exact over the reals, so
# the drift is float32 rounding alone (the reference's pinned value).
DRIFT_TOL = 1e-3


# -- running per-row moments -------------------------------------------------------


def row_moments(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (mean, M2), M2 = sum((x - mean)^2): the batch form of
    Welford's accumulator.  Seeds the moments of fresh rows with the
    arithmetic of the full transforms (the mean, then the centered sum of
    squares; pcc.transform's reductions), so a freshly seeded row's
    ``from_moments`` output is bitwise its cold pearson or covariance
    transform."""
    x = torch.as_tensor(x)
    xa = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = xa.mean(dim=1, keepdim=True)
    c = xa - mean
    m2 = (c * c).sum(dim=1, keepdim=True)
    return (mean[:, 0].to(torch.float32).contiguous(),
            m2[:, 0].to(torch.float32).contiguous())


def merge_row_moments(mean, m2, old_rows,
                      new_rows) -> Tuple[torch.Tensor, torch.Tensor]:
    """Welford-style delta merge: the moments of rows after their samples
    are replaced, from the old moments and the old and new values, in
    O(d l) and in the reference's order of float32 operations::

        mean' = mean + sum(new - old) / l
        M2'   = M2 + sum(new^2 - old^2) - l * (mean'^2 - mean^2)

    clamped at 0.  The sum-of-squares form cancels for low-variance rows in
    float32: the drift the corpus's drift budget bounds and the exact
    refresh repairs."""
    old = torch.as_tensor(old_rows).to(torch.float32)
    new = torch.as_tensor(new_rows).to(old.device, torch.float32)
    l = old.shape[1]
    mean = torch.as_tensor(mean).to(old.device, torch.float32)
    m2 = torch.as_tensor(m2).to(old.device, torch.float32)
    # a tensor divisor: on the card a division by a host scalar becomes a
    # multiply by its reciprocal, which can round differently
    div = torch.tensor(float(l), dtype=torch.float32, device=old.device)
    mean2 = mean + (new - old).sum(dim=1) / div
    m22 = m2 + (new * new - old * old).sum(dim=1) \
        - l * (mean2 * mean2 - mean * mean)
    return mean2, torch.clamp(m22, min=0.0)


def supports_incremental(meas: measures.Measure, compute_dtype) -> bool:
    """Whether (measure, dtype) can ride the O(delta l) moment path: the
    measure has a moment-form transform and the dtype needs no per-row
    quantization scales (maintaining those would re-quantize every row
    whose scale moved; the exact path handles them)."""
    return meas.incremental and not needs_row_scales(meas, compute_dtype)


# -- delta records --------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Delta:
    """One corpus mutation batch, as pushed to subscribers.

    kind       "append" (rows [lo, hi) are new) or "update" (rows at
               ``idx`` were replaced).
    generation the corpus generation after this mutation: the version every
               revalidated standing result names.
    """

    generation: int
    kind: str
    lo: int = 0
    hi: int = 0
    idx: Optional[np.ndarray] = None

    @property
    def count(self) -> int:
        return (self.hi - self.lo) if self.kind == "append" else len(self.idx)


# -- incremental operand maintenance ------------------------------------------


class IncrementalOperand:
    """A maintained prepared operand for one (measure, compute_dtype).

    State: the padded device operand (what
    :func:`~repro_torch.core.plan.prepare_operand_raw` produces), the
    per-row running moments it derives from, and the moment-merge update
    batches absorbed since the last exact build.  Every step builds new
    tensors and never writes the old ones: a batch in flight on another
    thread may still read them.
    """

    def __init__(self, x: torch.Tensor, meas: measures.Measure,
                 compute_dtype, t: int, l_blk: int, operand=None):
        if not supports_incremental(meas, compute_dtype):
            raise ValueError(
                f"measure {meas.name!r} with compute_dtype={compute_dtype} "
                f"has no incremental (moment-form) path")
        self.meas = meas
        self.compute_dtype = compute_dtype
        self.t = int(t)
        self.l_blk = int(l_blk)
        self.update_batches = 0
        self._build(torch.as_tensor(x), operand)

    def _build(self, x: torch.Tensor, operand=None) -> None:
        # `operand` lets the owner hand in x's prepared operand (the corpus
        # routes the first build through its TransformCache); it must be
        # exactly prepare_operand_raw's output
        self.n, self.l = x.shape
        self.u = operand if operand is not None else prepare_operand_raw(
            x, self.meas, self.compute_dtype, self.t, self.l_blk)
        self.mean, self.m2 = row_moments(x)
        self.update_batches = 0

    @property
    def operand(self):
        """The maintained padded operand: the drop-in ``v_pad``."""
        return self.u

    def _rows_operand(self, x_rows: torch.Tensor, mean: torch.Tensor,
                      m2: torch.Tensor) -> torch.Tensor:
        u = self.meas.from_moments(x_rows, mean, m2, self.l,
                                   dtype=torch.float32)
        if self.compute_dtype is not None:
            u = u.to(self.compute_dtype)
        l_pad = self.u.shape[1]
        if u.shape[1] < l_pad:
            u = F.pad(u, (0, l_pad - u.shape[1]))
        return u

    def append(self, x_new: torch.Tensor) -> None:
        """Extend by d fresh rows: an O(d l) transform and one row concat."""
        d = x_new.shape[0]
        mean_d, m2_d = row_moments(x_new)
        u_d = self._rows_operand(x_new, mean_d, m2_d)
        n1 = self.n + d
        n1_pad = -(-n1 // self.t) * self.t
        u = torch.cat([self.u[: self.n], u_d])
        if u.shape[0] < n1_pad:
            u = F.pad(u, (0, 0, 0, n1_pad - u.shape[0]))
        self.u = u
        self.mean = torch.cat([self.mean, mean_d])
        self.m2 = torch.cat([self.m2, m2_d])
        self.n = n1

    def update(self, idx, x_old_rows: torch.Tensor,
               x_new_rows: torch.Tensor) -> None:
        """Replace rows ``idx``: the Welford delta merge of their moments
        and an O(d l) rebuild of those operand rows.  Counts one drift
        batch (the merge is where float32 rounding accumulates)."""
        ji = torch.as_tensor(np.asarray(idx, np.int64), device=self.u.device)
        mean2, m22 = merge_row_moments(self.mean[ji], self.m2[ji],
                                       x_old_rows, x_new_rows)
        u_rows = self._rows_operand(x_new_rows, mean2, m22)
        self.u = self.u.index_copy(0, ji, u_rows)
        self.mean = self.mean.index_copy(0, ji, mean2)
        self.m2 = self.m2.index_copy(0, ji, m22)
        self.update_batches += 1

    def refresh(self, x: torch.Tensor) -> None:
        """Exact rebuild from the full corpus, bitwise a cold
        ``prepare_operand_raw``, and the drift counter reset."""
        self._build(x)

    def stats(self) -> dict:
        return {"rows": self.n, "update_batches": self.update_batches}


# -- standing top-k helpers ------------------------------------------------------


def topk_rows_from_dense(scores, k: int, col_ids=None, exclude_cols=None
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Canonical per-row top-k state of a dense (m, c) score block.

    ``col_ids`` maps local columns to global ids (default 0..c-1);
    ``exclude_cols`` drops one global column per row (self-pairs).  The
    merge order is the canonical one (|value| descending, column
    ascending), so the result is bitwise what a TopKSink over the same
    scores holds."""
    scores = np.asarray(scores, np.float32)
    m, c = scores.shape
    cols = (np.arange(c, dtype=np.int64) if col_ids is None
            else np.asarray(col_ids, np.int64))
    vals = np.zeros((m, k), np.float32)
    idx = np.full((m, k), -1, np.int64)
    r_ids = np.repeat(np.arange(m, dtype=np.int64), c)
    c_ids = np.tile(cols, m)
    v = scores.reshape(-1)
    if exclude_cols is not None:
        keep = c_ids != np.repeat(np.asarray(exclude_cols, np.int64), c)
        r_ids, c_ids, v = r_ids[keep], c_ids[keep], v[keep]
    topk_merge_rows(vals, idx, r_ids, c_ids, v, k)
    return vals, idx


def host_array(r: torch.Tensor) -> np.ndarray:
    """A dense device result as an owned (writable) host float32 array."""
    return np.array(r.cpu().numpy(), dtype=np.float32)


# -- LiveIndex: a standing corpus-vs-corpus result under deltas -------------------


class LiveIndex:
    """A standing all-pairs result over a live corpus.

    Subscribes to a :class:`~repro_torch.serving.corpus.CorpusHandle` and
    keeps the dense (n, n) matrix (``k=None``) or the per-row top-k
    (``k=int``) current under deltas:

      append(d)  launches ONLY the d-vs-n grid and the d-vs-d triangle and
                 merges: dense by row and column extension, top-k by the
                 per-row re-merge;
      update(d)  launches the d-vs-n grid of the revised rows; dense merges
                 rows and columns in place; top-k rebuilds the revised rows,
                 recomputes exactly the rows whose kept set referenced a
                 revised column (their k-th boundary may have moved), and
                 re-merges the revised values everywhere else.

    Delta plans ride the shared :class:`PlanCache` through tile-bucketed
    specs; ``recovery=`` arms the self-healing executor for each launch.
    ``result()`` copies name the generation they reflect.
    Revalidation runs synchronously on the mutating thread, so once
    ``corpus.append(...)`` returns the index is current.
    """

    def __init__(self, corpus, *, measure: measures.MeasureLike = "pearson",
                 k: Optional[int] = None, compute_dtype=None,
                 plan_cache: Optional[PlanCache] = None,
                 max_tiles_per_pass: Optional[int] = None, clip: bool = True,
                 fuse_epilogue: bool = True, mesh=None, recovery=None,
                 device=None):
        first = check_mesh(mesh, device)
        if not hasattr(corpus, "subscribe"):
            from repro_torch.serving.corpus import CorpusHandle
            corpus = CorpusHandle(
                corpus, device=device if first is None else first)
        check_mesh(mesh, corpus.device)
        if k is not None and k <= 0:
            raise ValueError(f"k must be positive, got {k}")
        self.corpus = corpus
        self.measure = measures.get(measure)
        self.k = k
        self.compute_dtype = compute_dtype
        self.plan_cache = plan_cache if plan_cache is not None else PlanCache()
        self.max_tiles_per_pass = max_tiles_per_pass
        self.clip = clip
        self.fuse_epilogue = fuse_epilogue
        self.mesh = mesh
        self.recovery = recovery
        self._lock = threading.Lock()
        self.deltas_applied = 0
        self.rebuilds = 0
        with self._lock:
            self._rebuild()
        self._unsubscribe = corpus.subscribe(self._on_delta)

    # -- plan resolution -------------------------------------------------------

    def _spec(self, rows: int, cols: Optional[int]) -> ProblemSpec:
        return ProblemSpec.for_query(
            rows, cols, self.corpus.l, measure=self.measure,
            t=self.corpus.t, l_blk=self.corpus.l_blk,
            compute_dtype=self.compute_dtype, clip=self.clip,
            fuse_epilogue=self.fuse_epilogue,
            max_tiles_per_pass=self.max_tiles_per_pass, mesh=self.mesh)

    def _operand(self):
        return self.corpus.operand(self.measure, self.compute_dtype)

    def _grid_block(self, u, rows, n_cols: int) -> np.ndarray:
        """One rectangular delta launch: `rows` of the prepared operand
        against its first n_cols rows, dense, cropped to the real rows."""
        plan, _ = self.plan_cache.get(self._spec(len(rows), n_cols))
        dev = operand_data(u).device
        u_rows = take_operand_rows(
            u, torch.as_tensor(np.asarray(rows, np.int64), device=dev),
            plan.n_pad)
        v_cols = take_operand_rows(u, slice(0, plan.col_pad), plan.col_pad)
        out = execute_plan(plan, u_rows, v_cols, sink=DenseSink(),
                           device=dev, mesh=self.mesh,
                           recovery=self.recovery)
        return host_array(out)[: len(rows)]

    # -- full (re)build --------------------------------------------------------------

    def _rebuild(self) -> None:
        n = self.corpus.n
        plan, _ = self.plan_cache.get(self._spec(n, None))
        u = self._operand()
        dev = operand_data(u).device
        if self.k is None:
            self._r = host_array(execute_plan(
                plan, u, sink=DenseSink(), device=dev, mesh=self.mesh,
                recovery=self.recovery))
        else:
            top = execute_plan(plan, u, sink=TopKSink(self.k), device=dev,
                               mesh=self.mesh, recovery=self.recovery)
            self._vals = np.array(top["values"], dtype=np.float32)
            self._idx = np.array(top["indices"], dtype=np.int64)
        self._generation = self.corpus.generation
        self.rebuilds += 1

    def rebuild(self) -> None:
        """Force a cold full rebuild (drops every incrementally merged
        state; the result is what a cold ``corr()`` returns)."""
        with self._lock:
            self._rebuild()

    # -- delta application --------------------------------------------------------

    def _on_delta(self, delta: Delta) -> None:
        with self._lock:
            if delta.generation != self._generation + 1:
                # a missed or out-of-order delta: resync exactly
                self._rebuild()
                return
            if delta.kind == "append":
                self._apply_append(delta)
            else:
                self._apply_update(delta)
            self._generation = delta.generation
            self.deltas_applied += 1

    def _apply_append(self, delta: Delta) -> None:
        n0, n1 = delta.lo, delta.hi
        d = n1 - n0
        u = self._operand()
        # the d-vs-n0 rectangular grid ...
        g = self._grid_block(u, np.arange(n0, n1), n0) if n0 else \
            np.zeros((d, 0), np.float32)
        # ... and the d-vs-d triangle, never the full (n0 + d) triangle
        plan_t, _ = self.plan_cache.get(self._spec(d, None))
        u_d = take_operand_rows(u, slice(n0, n1), plan_t.n_pad)
        tt = host_array(execute_plan(plan_t, u_d, sink=DenseSink(),
                                     device=operand_data(u).device,
                                     mesh=self.mesh, recovery=self.recovery))
        if self.k is None:
            r = np.zeros((n1, n1), np.float32)
            r[:n0, :n0] = self._r
            r[n0:, :n0] = g
            r[:n0, n0:] = g.T
            r[n0:, n0:] = tt
            self._r = r
            return
        vals = np.zeros((n1, self.k), np.float32)
        idx = np.full((n1, self.k), -1, np.int64)
        vals[:n0], idx[:n0] = self._vals, self._idx
        # old rows gain the new columns; new rows gain everything they see
        new_ids = np.arange(n0, n1, dtype=np.int64)
        r_ids = np.concatenate([
            np.repeat(np.arange(n0, dtype=np.int64), d),    # g.T -> old rows
            np.repeat(new_ids, n0),                          # g -> new rows
            np.repeat(new_ids, d),                           # tt -> new rows
        ])
        c_ids = np.concatenate([
            np.tile(new_ids, n0),
            np.tile(np.arange(n0, dtype=np.int64), d),
            np.tile(new_ids, d),
        ])
        v = np.concatenate([g.T.reshape(-1), g.reshape(-1), tt.reshape(-1)])
        keep = r_ids != c_ids  # drop the triangle's diagonal (self-pairs)
        topk_merge_rows(vals, idx, r_ids[keep], c_ids[keep], v[keep], self.k)
        self._vals, self._idx = vals, idx

    def _apply_update(self, delta: Delta) -> None:
        idx = np.asarray(delta.idx, np.int64)
        n = self.corpus.n
        u = self._operand()
        ru = self._grid_block(u, idx, n)        # (d, n), revised values
        if self.k is None:
            self._r[idx, :] = ru
            self._r[:, idx] = ru.T
            return
        # 1. revised rows: their whole neighbourhood recomputes from ru
        self._vals[idx], self._idx[idx] = topk_rows_from_dense(
            ru, self.k, exclude_cols=idx)
        # 2. rows whose kept set referenced a revised column: the stored
        #    value is stale and the k-th boundary may move, so recompute
        #    them exactly with one more (bucketed) grid launch
        updated = np.zeros(n, bool)
        updated[idx] = True
        stale_mask = updated[np.clip(self._idx, 0, n - 1)] & (self._idx >= 0)
        stale_mask = stale_mask.any(axis=1)
        stale_mask[idx] = False
        stale = np.where(stale_mask)[0]
        if stale.size:
            rs = self._grid_block(u, stale, n)
            self._vals[stale], self._idx[stale] = topk_rows_from_dense(
                rs, self.k, exclude_cols=stale)
        # 3. every other row only gains candidates at the revised columns
        rest = np.where(~stale_mask & ~updated)[0]
        if rest.size:
            d = idx.size
            r_ids = np.repeat(rest, d)
            c_ids = np.tile(idx, rest.size)
            v = ru[:, rest].T.reshape(-1)
            topk_merge_rows(self._vals, self._idx, r_ids, c_ids, v, self.k)

    # -- results ---------------------------------------------------------------------

    @property
    def generation(self) -> int:
        return self._generation

    def result(self) -> dict:
        """A copy of the standing result, naming its generation: dense
        indexes return {"r", "generation"}, top-k ones {"indices",
        "values", "generation"}."""
        with self._lock:
            if self.k is None:
                return {"r": self._r.copy(), "generation": self._generation}
            vals = self._vals.copy()
            vals[self._idx < 0] = 0.0
            return {"indices": self._idx.copy(), "values": vals,
                    "generation": self._generation}

    def stats(self) -> dict:
        return {"generation": self._generation, "rows": self.corpus.n,
                "deltas_applied": self.deltas_applied,
                "rebuilds": self.rebuilds,
                "plan_cache": self.plan_cache.stats()}

    def close(self) -> None:
        """Unsubscribe from the corpus (the standing state stays readable,
        frozen at its last generation)."""
        self._unsubscribe()

    def __enter__(self) -> "LiveIndex":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


__all__ = [
    "DEFAULT_DRIFT_BUDGET",
    "DRIFT_TOL",
    "Delta",
    "IncrementalOperand",
    "LiveIndex",
    "merge_row_moments",
    "row_moments",
    "supports_incremental",
    "topk_rows_from_dense",
]
