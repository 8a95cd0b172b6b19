"""QueryBatcher: coalesce small probe queries into one grid launch.

Port of ``repro/serving/batcher.py``.  Interactive co-expression queries
are small, a handful of probe profiles against an n-gene corpus, and a
launch per query wastes the card.  The engine's output rows are
independent (row i of U V^T depends only on row i of U), so stacking
request slabs row-wise changes no result bit.

``execute()`` serves a list of :class:`Query` objects with the fewest
launches:

  1. group by (measure, output kind): dense rows and per-row top-k take
     different sinks;
  2. per group, bucket the stacked row count to a tile multiple
     (plan_cache.bucket_rows) and fetch the frozen plan from the
     :class:`~repro_torch.serving.plan_cache.PlanCache`;
  3. one ``execute_plan`` run: the corpus operand comes prepared from the
     :class:`~repro_torch.serving.corpus.CorpusHandle`, the requests' slabs
     through ``ExecutionPlan.prepare_rows`` (each transformed at its own
     shape, then stacked and zero-padded to the bucket);
  4. scatter the results: dense groups stream through
     :class:`~repro_torch.core.sinks.RowBlockSink` into one host array per
     request; top-k groups run one sink at the group's largest k and each
     request takes its rows and its leading k_i columns (the first k_i of a
     canonical top-k_max list are the top-k_i).  The top-k sink is
     :class:`~repro_torch.core.sinks.DeviceTopKSink` (the top-k kernel)
     where it supports the plan, else :class:`~repro_torch.core.sinks.
     TopKSink`: the reference's policy; both give the same bits.

Results are bitwise per-request ``corr(probes, corpus, ...)`` calls.  With
``mesh=`` every launch runs over the mesh (the corpus on its first
device), and each launch reports its per-rank tile occupancy.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import measures
from repro_torch.core.allpairs import check_mesh, execute_plan
from repro_torch.core.sinks import DeviceTopKSink, RowBlockSink, TopKSink
from repro_torch.kernels.pcc_tile import DEFAULT_LBLK, DEFAULT_TILE
from repro_torch.serving.corpus import CorpusHandle, as_corpus
from repro_torch.serving.plan_cache import PlanCache, ProblemSpec


@dataclasses.dataclass
class Query:
    """One serving request: (m, l) probe profiles against the corpus.

    k=None returns the dense (m, n) correlation rows as a host float32
    array; an integer k the per-row top-k corpus partners ({"indices",
    "values"}, as TopKSink).  measure=None takes the batcher's default.
    """

    probes: Any
    k: Optional[int] = None
    measure: Optional[measures.MeasureLike] = None

    def __post_init__(self):
        # Validation is eager and complete: a Query is usually built inside
        # CorrServer.submit(), and a malformed one must be refused there;
        # once co-batched, a poisoned probe (NaN / Inf, a complex or object
        # dtype) would fail or corrupt every batch-mate's answer.
        p = self.probes
        if not isinstance(p, torch.Tensor):
            arr = np.asarray(p)
            if arr.dtype.kind not in "fiub":
                raise ValueError(
                    f"probes must be real-valued (floating or integer), "
                    f"got dtype {arr.dtype}")
            p = torch.as_tensor(arr)
        if p.ndim != 2 or p.shape[0] < 1:
            raise ValueError(
                f"probes must be (m >= 1, l), got shape {tuple(p.shape)}")
        if p.is_complex() or p.dtype == torch.bool:
            raise ValueError(
                f"probes must be real-valued (floating or integer), got "
                f"dtype {p.dtype}")
        if not bool(torch.isfinite(p).all()):
            raise ValueError(
                "probes contain non-finite values (NaN/Inf); masked "
                "missing-data queries are not served through the batcher — "
                "use corr(probes, corpus, where='nan') directly")
        if self.k is not None and self.k <= 0:
            raise ValueError(f"k must be positive, got {self.k}")
        self.probes = p

    @property
    def m(self) -> int:
        return self.probes.shape[0]


@dataclasses.dataclass
class BatchInfo:
    """What one coalesced launch looked like (reported per request)."""

    requests: int           # queries coalesced into this launch
    rows: int               # real probe rows in the slab
    rows_bucket: int        # padded launch rows (tile multiple)
    plan_cache_hit: bool
    passes: int
    # per-rank tile occupancy of a mesh launch: element r is rank r's
    # assigned tiles / per-rank capacity (the trailing ranks of a ceil
    # partition idle below 1.0); None without a mesh
    host_occupancy: Optional[tuple] = None

    @property
    def occupancy(self) -> float:
        """Real rows / launched rows: 1.0 means no padding waste."""
        return self.rows / self.rows_bucket if self.rows_bucket else 0.0


class QueryBatcher:
    """Executes query batches against one registered corpus.

    The synchronous core of the serving layer: :class:`CorrServer` owns the
    queueing and wait policy and calls ``execute()`` from its dispatcher
    thread; direct callers can use it as a batch API.  ``device`` places a
    corpus given as an array (None means "cuda", or the mesh's first
    device); a handle keeps its own, which must be the mesh's first device
    when ``mesh`` is given.
    """

    def __init__(self, corpus, *,
                 measure: measures.MeasureLike = "pearson",
                 plan_cache: Optional[PlanCache] = None,
                 t: int = DEFAULT_TILE, l_blk: int = DEFAULT_LBLK,
                 compute_dtype=None, clip: bool = True,
                 fuse_epilogue: bool = True,
                 max_tiles_per_pass: Optional[int] = None,
                 mesh=None, device=None):
        first = check_mesh(mesh, device)
        self.corpus: CorpusHandle = as_corpus(
            corpus, t=t, l_blk=l_blk, device=device if first is None
            else first)
        check_mesh(mesh, self.corpus.device)
        self.measure = measures.get(measure)
        self.plan_cache = plan_cache if plan_cache is not None else PlanCache()
        self.t = int(t)
        self.l_blk = int(l_blk)
        self.compute_dtype = compute_dtype
        self.clip = clip
        self.fuse_epilogue = fuse_epilogue
        self.max_tiles_per_pass = max_tiles_per_pass
        self.mesh = mesh

    # -- internals -----------------------------------------------------------------

    def _resolve_measure(self, q: Query) -> measures.Measure:
        return self.measure if q.measure is None else measures.get(q.measure)

    def _spec(self, rows: int, meas: measures.Measure) -> ProblemSpec:
        return ProblemSpec.for_query(
            rows, self.corpus.n, self.corpus.l, measure=meas,
            t=self.t, l_blk=self.l_blk, compute_dtype=self.compute_dtype,
            clip=self.clip, fuse_epilogue=self.fuse_epilogue,
            max_tiles_per_pass=self.max_tiles_per_pass, mesh=self.mesh)

    def _launch_group(self, meas: measures.Measure, group: List[Query],
                      topk: bool):
        """One coalesced launch for queries sharing (measure, kind)."""
        dev = self.corpus.device
        rows = sum(q.m for q in group)
        plan, hit = self.plan_cache.get(self._spec(rows, meas))
        u_pad = plan.prepare_rows([q.probes.to(dev) for q in group])
        # the plan's resolved measure (kendall at l >= 96 is the merge
        # kernel's, whose operand is ranks) prepares the corpus too
        v_pad = self.corpus.operand(plan.measure, plan.compute_dtype)

        bounds, lo = [], 0
        for q in group:
            bounds.append((lo, lo + q.m))
            lo += q.m

        if topk:
            kmax = max(q.k for q in group)
            sink = (DeviceTopKSink(kmax) if DeviceTopKSink.supports(plan)
                    else TopKSink(kmax))
            top = execute_plan(plan, u_pad, v_pad, sink=sink, device=dev,
                               mesh=self.mesh)
            outs = [{"indices": top["indices"][lo:hi, : q.k].copy(),
                     "values": top["values"][lo:hi, : q.k].copy()}
                    for (lo, hi), q in zip(bounds, group)]
        else:
            outs = execute_plan(plan, u_pad, v_pad,
                                sink=RowBlockSink(bounds), device=dev,
                                mesh=self.mesh)
        host_occ = None
        if self.mesh is not None:
            host_occ = tuple((hi - lo) / plan.per_dev
                             for lo, hi in plan.device_ranges)
        info = BatchInfo(requests=len(group), rows=rows,
                         rows_bucket=plan.n_rows, plan_cache_hit=hit,
                         passes=plan.n_pass, host_occupancy=host_occ)
        return outs, info

    # -- public --------------------------------------------------------------------

    def execute(self, queries: List[Query]):
        """Serve a batch with the fewest launches: (results, infos) in the
        input order.  results[i] is the dense (m_i, n) host array or the
        top-k dict of queries[i]; infos[i] the launch that served it."""
        for q in queries:
            if q.probes.shape[1] != self.corpus.l:
                raise ValueError(
                    f"probes have l={q.probes.shape[1]} samples, corpus "
                    f"has l={self.corpus.l}")
        groups: Dict[tuple, List[int]] = {}
        group_meas: Dict[tuple, measures.Measure] = {}
        for i, q in enumerate(queries):
            meas = self._resolve_measure(q)
            # by measure identity, not name: a custom Measure shadowing a
            # registry name must not share a launch with it
            key = (id(meas), q.k is not None)
            groups.setdefault(key, []).append(i)
            group_meas[key] = meas

        results: List[Any] = [None] * len(queries)
        infos: List[Optional[BatchInfo]] = [None] * len(queries)
        for key, idxs in groups.items():
            group = [queries[i] for i in idxs]
            outs, info = self._launch_group(group_meas[key], group, key[1])
            for i, out in zip(idxs, outs):
                results[i] = out
                infos[i] = info
        return results, infos


__all__ = ["Query", "QueryBatcher", "BatchInfo"]
