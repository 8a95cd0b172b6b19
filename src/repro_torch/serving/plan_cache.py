"""PlanCache: frozen ExecutionPlans keyed on bucketed problem specs.

Port of ``repro/serving/plan_cache.py``.  Serving turns ``corr()`` into a
stream of small queries, and two levers keep their per-call host cost
down:

  * **shape bucketing**: probe row counts round up to the tile multiple
    (``bucket_rows``), so every query of 1..t probes shares one plan;
    zero-padded probe rows are inert (ExecutionPlan.prepare_rows).  The
    corpus side keeps its exact row count: bucketing it would leak padding
    columns into results.
  * **spec-keyed reuse**: a frozen :class:`ProblemSpec` holds every field
    that decides a plan (measure, bucketed shapes, sample count, tile
    geometry, dtype); equal specs get the same ExecutionPlan object back.

The CUDA kernels take every shape at run time (nothing is traced or
compiled per shape), so what the cache saves here is plan construction;
it also keeps the reference's hit / miss counters, which the server
reports per request.  A mesh is part of the key (:func:`mesh_key`), and
its size is the plan's p.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core import measures
from repro_torch.core.lru import LruStatsCache
from repro_torch.core.plan import ExecutionPlan
from repro_torch.kernels.pcc_tile import DEFAULT_LBLK, DEFAULT_TILE, \
    dtype_name
from repro_torch.launch.mesh import Mesh


def bucket_rows(rows: int, t: int) -> int:
    """Round a probe row count up to the tile multiple: the shape bucket
    every query of 1..t, t+1..2t, ... probes shares."""
    if rows <= 0:
        raise ValueError(f"rows must be positive, got {rows}")
    return -(-rows // t) * t


def mesh_key(mesh) -> Optional[tuple]:
    """The hashable identity of a device mesh for spec keying: its axes
    and sizes plus the device of each flat rank, so two meshes over
    different devices never share a plan even when their shapes agree
    (None for mesh=None).  Anything but a launch.mesh.Mesh raises
    TypeError."""
    if mesh is None:
        return None
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a repro_torch.launch.mesh.Mesh, "
                        f"got {type(mesh).__name__}")
    return (tuple(mesh.shape.items()), tuple(str(d) for d in mesh.ranks))


@dataclasses.dataclass(frozen=True)
class ProblemSpec:
    """The bucketed identity of a serving query shape: the cache key.

    Mirrors ``ExecutionPlan.spec_dict()``: two queries with equal specs are
    served by the same frozen plan.  ``cols`` is None for the symmetric
    workload, else the corpus's exact row count (only the probe side
    buckets).  Measure identity is (name, object id): registered names
    resolve to module singletons, and an unregistered custom Measure, which
    ``corr()`` accepts, is told apart by identity even when its name
    shadows a registry key.  The resolved object rides along outside
    equality and hashing (``measure_ref``), so ``build()`` uses it directly
    and its id cannot be recycled while a cache holds the spec.  The
    reference's ``interpret`` field has no counterpart (the port has no
    interpret mode).
    """

    measure: str
    rows: int                      # bucketed probe rows (tile multiple)
    cols: Optional[int]            # exact corpus rows; None = symmetric
    l: int                         # sample count
    measure_id: int = 0            # id(resolved Measure): identity key
    measure_ref: Optional[measures.Measure] = dataclasses.field(
        default=None, compare=False, repr=False)
    t: int = DEFAULT_TILE
    l_blk: int = DEFAULT_LBLK
    compute_dtype: Optional[str] = None
    clip: bool = True
    fuse_epilogue: bool = True
    max_tiles_per_pass: Optional[int] = None
    mesh: Optional[tuple] = None   # mesh_key(mesh) or None

    @classmethod
    def for_query(cls, n_probes: int, corpus_n: Optional[int], l: int, *,
                  measure: measures.MeasureLike = "pearson",
                  t: int = DEFAULT_TILE, l_blk: int = DEFAULT_LBLK,
                  compute_dtype=None, clip: bool = True,
                  fuse_epilogue: bool = True,
                  max_tiles_per_pass: Optional[int] = None,
                  mesh=None) -> "ProblemSpec":
        """Spec of an m-probes-vs-corpus query (corpus_n None: the
        symmetric workload over the probes themselves, not bucketed: its
        output is (n, n), and padding rows would be padding columns)."""
        cd = None if compute_dtype is None else dtype_name(compute_dtype)
        rows = n_probes if corpus_n is None else bucket_rows(n_probes, t)
        meas = measures.get(measure)
        return cls(measure=meas.name, measure_id=id(meas), measure_ref=meas,
                   rows=rows, cols=corpus_n, l=l, t=t, l_blk=l_blk,
                   compute_dtype=cd, clip=clip, fuse_epilogue=fuse_epilogue,
                   max_tiles_per_pass=max_tiles_per_pass,
                   mesh=mesh_key(mesh))

    @property
    def p(self) -> int:
        """The plan's rank count: the mesh's size, 1 without a mesh."""
        return 1 if self.mesh is None else len(self.mesh[1])

    def build(self) -> ExecutionPlan:
        """The ExecutionPlan this spec describes."""
        return ExecutionPlan.create(
            self.rows, self.l, n_cols=self.cols, t=self.t, l_blk=self.l_blk,
            measure=(self.measure_ref if self.measure_ref is not None
                     else self.measure), p=self.p,
            max_tiles_per_pass=self.max_tiles_per_pass, clip=self.clip,
            fuse_epilogue=self.fuse_epilogue,
            compute_dtype=self.compute_dtype)


class PlanCache(LruStatsCache):
    """Bounded LRU of spec -> frozen ExecutionPlan, with hit / miss counts.

    Equal specs return the same plan object.  Thread-safe: the server
    resolves plans on its dispatcher thread while sync callers resolve
    their own.
    """

    def __init__(self, capacity: int = 32):
        super().__init__(capacity)

    def get(self, spec: ProblemSpec) -> Tuple[ExecutionPlan, bool]:
        """(plan, was_hit) for a spec; builds and caches on a miss,
        evicting the least recently used spec beyond capacity."""
        plan = self._lookup(spec)
        if plan is not None:
            return plan, True
        plan = spec.build()  # host-side planning, outside the lock
        self._insert(spec, plan)
        return plan, False


__all__ = ["ProblemSpec", "PlanCache", "bucket_rows", "mesh_key"]
