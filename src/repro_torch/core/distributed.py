"""Distributed all-pairs similarity over a device mesh (paper SSIII-D, C5).

Port of ``repro/core/distributed.py``.  All mesh execution lives in the
executor (core/allpairs.py with ``mesh=``): the ExecutionPlan gives each
flat rank the paper's contiguous tile-id range [i ceil(T/p), (i + 1)
ceil(T/p)), and the executor streams each pass's per-rank pieces to the
caller's TileSink, so no (p per_dev, t, t) global tile array is ever
built.  The two historical drivers below are deprecated spellings of
``corr(x, mesh=mesh, ...)``, bitwise it, each warning once a call:

* allpairs_pcc_sharded:   U copied to every device of the mesh;
* allpairs_pcc_sharded_u: U row-sharded over the ranks and gathered onto
  each device once a pass.

Both return the assembled (n, n) matrix, or the sink's result.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.core import measures
from repro_torch.core.allpairs import allpairs, warn_deprecated_driver
from repro_torch.core.plan import tiles_per_device
from repro_torch.core.sinks import TileSink
from repro_torch.kernels.pcc_tile import DEFAULT_LBLK, DEFAULT_TILE
from repro_torch.launch.mesh import Mesh


def allpairs_pcc_sharded(x, mesh: Mesh, *, t: int = DEFAULT_TILE,
                         l_blk: int = DEFAULT_LBLK,
                         max_tiles_per_pass: Optional[int] = None,
                         measure: measures.MeasureLike = "pearson",
                         fuse_epilogue: bool = True, compute_dtype=None,
                         sink: Optional[TileSink] = None, device=None):
    """Distributed all-pairs similarity: the full (n, n) matrix on the
    mesh's first device (Pearson by default), or the sink's result.
    Deprecated spelling of ``corr(x, mesh=mesh, ...)``."""
    warn_deprecated_driver("allpairs_pcc_sharded", "x, mesh=mesh, ...")
    return allpairs(x, mesh=mesh, measure=measure, sink=sink, t=t,
                    l_blk=l_blk, max_tiles_per_pass=max_tiles_per_pass,
                    fuse_epilogue=fuse_epilogue,
                    compute_dtype=compute_dtype, device=device)


def allpairs_pcc_sharded_u(x, mesh: Mesh, *, t: int = DEFAULT_TILE,
                           l_blk: int = DEFAULT_LBLK,
                           max_tiles_per_pass: Optional[int] = None,
                           measure: measures.MeasureLike = "pearson",
                           fuse_epilogue: bool = True, compute_dtype=None,
                           sink: Optional[TileSink] = None, device=None):
    """Row-sharded-U variant: deprecated spelling of ``corr(x, mesh=mesh,
    shard_u=True, ...)``, bitwise allpairs_pcc_sharded."""
    warn_deprecated_driver("allpairs_pcc_sharded_u",
                           "x, mesh=mesh, shard_u=True, ...")
    return allpairs(x, mesh=mesh, shard_u=True, measure=measure, sink=sink,
                    t=t, l_blk=l_blk, max_tiles_per_pass=max_tiles_per_pass,
                    fuse_epilogue=fuse_epilogue,
                    compute_dtype=compute_dtype, device=device)


# Measure-agnostic aliases (the `_pcc` names serve every measure).
allpairs_sharded = allpairs_pcc_sharded
allpairs_sharded_u = allpairs_pcc_sharded_u

__all__ = ["allpairs_pcc_sharded", "allpairs_pcc_sharded_u",
           "allpairs_sharded", "allpairs_sharded_u", "tiles_per_device"]
