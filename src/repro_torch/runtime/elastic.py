"""Elastic re-meshing: tile ownership as a pure function of the counts.

Port of ``repro/runtime/elastic.py`` on the port's meshes
(launch/mesh.Mesh).  The paper's bijection makes all-pairs work assignment
stateless: tile ranges are pure functions of (total, p, i), so
re-partitioning after a failure is a renumbering, not a job-table
migration.  The mesh shrinks around the lost devices (:func:`shrink_mesh`,
the recovering executor's default, core/allpairs._default_shrink, or
:func:`shrink_data_axis` / :func:`build_mesh`, which keep the model axis
of a 2-D mesh whole) and the plan re-slices onto the survivors
(:func:`replan_execution`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import tiling
from repro_torch.core.plan import ExecutionPlan
from repro_torch.launch.mesh import Mesh, make_mesh, visible_devices


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    old_shape: Tuple[int, ...]
    new_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    dropped_devices: int                # devices idled beyond the failures
    new_tile_ranges: Optional[Tuple[Tuple[int, int], ...]] = None
    new_exec_plan: Optional[ExecutionPlan] = None


def shrink_data_axis(mesh: Mesh, n_failed: int,
                     data_axis: str = "data") -> ElasticPlan:
    """Shrink the data axis to the largest size whose device requirement is
    met by the survivors; the other axes are kept."""
    names = tuple(mesh.axis_names)
    shape = tuple(mesh.devices.shape)
    sizes = dict(zip(names, shape))
    if data_axis not in sizes:
        raise ValueError(f"mesh has no axis {data_axis!r}")
    total = int(np.prod(shape))
    alive = total - n_failed
    other = total // sizes[data_axis]
    new_data = alive // other
    if new_data < 1:
        raise RuntimeError(
            f"cannot re-mesh: only {alive} devices left, model plane "
            f"needs {other}")
    new_sizes = dict(sizes)
    new_sizes[data_axis] = new_data
    new_shape = tuple(new_sizes[a] for a in names)
    dropped = alive - int(np.prod(new_shape))
    return ElasticPlan(old_shape=shape, new_shape=new_shape,
                       axis_names=names, dropped_devices=dropped)


def build_mesh(plan: ElasticPlan, devices: Optional[Sequence] = None) -> Mesh:
    """Lay the plan's shape over the first surviving devices (every visible
    CUDA device when `devices` is None; a real deployment passes the
    post-failure device list)."""
    devs = list(visible_devices() if devices is None else devices)
    need = int(np.prod(plan.new_shape))
    if len(devs) < need:
        raise RuntimeError(f"need {need} devices, have {len(devs)}")
    return make_mesh(plan.new_shape, plan.axis_names, devices=devs[:need])


def replan_pcc(total_tiles: int, new_p: int) -> Tuple[Tuple[int, int], ...]:
    """Stateless re-partition of the tile ranges for a new PE count: a pure
    renumbering, thanks to the bijection (C1 / C5)."""
    return tuple(tiling.balanced_counts(total_tiles, new_p))


def shrink_mesh(mesh: Mesh, n_failed: int = 1) -> Optional[Mesh]:
    """Survivor mesh after losing `n_failed` devices of `mesh`: the
    remaining ranks flattened onto one axis ("rank"; the executor
    flattens every mesh to one rank axis, so the topology need not
    survive), or None when one rank survives (the executor then launches
    locally, on the mesh's first device).  The last ranks go, the policy
    build_mesh's first-N survivors match; a real deployment drops the
    devices that failed."""
    devs = mesh.devices.reshape(-1)
    alive = devs.size - int(n_failed)
    if alive < 1:
        raise RuntimeError(
            f"cannot re-mesh: {n_failed} failures leave no survivors of "
            f"the {devs.size}-device mesh")
    if alive == 1:
        return None
    return Mesh(devs[:alive], ("rank",))


def replan_execution(plan: ExecutionPlan, new_p: int) -> ExecutionPlan:
    """Re-slice a plan for the surviving rank count: only p, per_dev and
    the pass bound change, so the executor resumes with the same kernels
    and the new contiguous ranges."""
    return plan.repartition(new_p)


def host_shard_plan(plan: ExecutionPlan,
                    n_hosts: int) -> Tuple[Tuple[int, int], ...]:
    """Per-host output ranges of a multi-host run: element h is the [lo, hi)
    tile-id range host h's ShardedHostSink persists (core/sinks.py).  A
    pure function of (plan, n_hosts), so every host derives its range with
    no coordination."""
    if n_hosts <= 0:
        raise ValueError(f"n_hosts must be positive, got {n_hosts}")
    return tuple(plan.host_tile_range(h, n_hosts) for h in range(n_hosts))


def elastic_pcc_plan(mesh: Mesh, n_failed: int, total_tiles: int,
                     data_axis: str = "data",
                     exec_plan: Optional[ExecutionPlan] = None) -> ElasticPlan:
    """Shrink the mesh's data axis and re-partition the tile ranges; with
    `exec_plan` (the run's ExecutionPlan) the result also carries it
    re-sliced for the new device count."""
    plan = shrink_data_axis(mesh, n_failed, data_axis)
    p_new = int(np.prod(plan.new_shape))
    new_exec = None
    if exec_plan is not None:
        if exec_plan.total_tiles != total_tiles:
            raise ValueError(
                f"exec_plan.total_tiles={exec_plan.total_tiles} does not "
                f"match total_tiles={total_tiles}")
        new_exec = replan_execution(exec_plan, p_new)
    return dataclasses.replace(
        plan, new_tile_ranges=replan_pcc(total_tiles, p_new),
        new_exec_plan=new_exec)


__all__ = ["ElasticPlan", "shrink_data_axis", "shrink_mesh", "build_mesh",
           "replan_pcc", "replan_execution", "elastic_pcc_plan",
           "host_shard_plan"]
