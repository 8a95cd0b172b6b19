"""Elastic re-partitioning: tile ownership as a pure function of the counts.

Port of the one-device part of ``repro/runtime/elastic.py``.  The paper's
bijection makes all-pairs work assignment stateless: tile ranges are pure
functions of (total, p, i), so re-partitioning after a failure is a
renumbering, not a job-table migration.  Here: :func:`replan_pcc` (the
tile ranges of a new PE count) and :func:`host_shard_plan` (the output
ranges of a sharded multi-host result, core/sinks.ShardedHostSink).

The mesh side of the reference's module (``ElasticPlan``,
``shrink_data_axis``, ``build_mesh``, ``shrink_mesh``,
``replan_execution``, ``elastic_pcc_plan``) needs more than one device and
comes with ROADMAP A6.  On one device a lost device has no survivor: the
recovering executor re-raises it (core/allpairs._default_shrink).
"""

from __future__ import annotations

from typing import Tuple

from repro_torch.core import tiling
from repro_torch.core.plan import ExecutionPlan


def replan_pcc(total_tiles: int, new_p: int) -> Tuple[Tuple[int, int], ...]:
    """Stateless re-partition of the tile ranges for a new PE count: a pure
    renumbering, thanks to the bijection (C1 / C5)."""
    return tuple(tiling.balanced_counts(total_tiles, new_p))


def host_shard_plan(plan: ExecutionPlan,
                    n_hosts: int) -> Tuple[Tuple[int, int], ...]:
    """Per-host output ranges of a multi-host run: element h is the [lo, hi)
    tile-id range host h's ShardedHostSink persists (core/sinks.py).  A
    pure function of (plan, n_hosts), so every host derives its range with
    no coordination."""
    if n_hosts <= 0:
        raise ValueError(f"n_hosts must be positive, got {n_hosts}")
    return tuple(plan.host_tile_range(h, n_hosts) for h in range(n_hosts))


__all__ = ["replan_pcc", "host_shard_plan"]
