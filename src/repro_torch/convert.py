"""State carried across from the reference package.

The system has no weights: a run's state is its plan and its prepared
operand.  ``plan_from_reference`` rebuilds the port's plan from a reference
``ExecutionPlan.spec_dict()`` (a plain dict, as the reference writes it into
its checkpoint sidecars); ``operand_from_reference`` takes the reference's
prepared operand as a numpy array (``np.asarray(plan.prepare(x))``).  Both
packages then compute the same tiles from the same operand.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.allpairs import resolve_device
from repro_torch.core.plan import ExecutionPlan

# spec_dict fields that select modes later slices bring, with the values
# the port runs so far
_PORTED = {"tile_kernel": (None,), "symmetric_grid": (False,),
           "compute_dtype": (None, "bfloat16", "int8"),
           "p": (1,), "replicas": (0,)}
_WORKLOADS = ("TriangularWorkload", "GridWorkload")


def plan_from_reference(spec: dict) -> ExecutionPlan:
    """The port's ExecutionPlan for a reference plan's ``spec_dict()``
    (triangular or rectangular grid).

    Raises NotImplementedError for modes the port does not run yet and
    ValueError when the rebuilt plan's spec_dict() differs from `spec`.
    """
    for key, want in _PORTED.items():
        if spec.get(key) not in want:
            raise NotImplementedError(
                f"reference plan has {key}={spec.get(key)!r}; the port runs "
                f"{key} in {want} so far (see ROADMAP queue A)")
    if spec.get("workload") not in _WORKLOADS:
        raise NotImplementedError(
            f"reference plan has workload={spec.get('workload')!r}; the "
            f"port runs {_WORKLOADS}")
    grid = spec["workload"] == "GridWorkload"
    if not grid and spec["n_rows"] != spec["n_cols"]:
        raise ValueError(f"a triangular spec has n_rows == n_cols, got {spec}")
    plan = ExecutionPlan.create(
        spec["n_rows"], spec["l"], n_cols=spec["n_cols"] if grid else None,
        t=spec["t"], l_blk=spec["l_blk"],
        measure=spec["measure"],
        max_tiles_per_pass=spec["max_tiles_per_pass"], clip=spec["clip"],
        fuse_epilogue=spec["fused"], compute_dtype=spec["compute_dtype"])
    if plan.spec_dict() != spec:
        raise ValueError(f"rebuilt plan {plan.spec_dict()} differs from the "
                         f"reference spec {spec}")
    return plan


def operand_from_reference(u_pad, device=None) -> torch.Tensor:
    """The reference's prepared (n_pad, l_pad) operand — the row operand,
    or a rectangular plan's column operand v_pad — as a contiguous tensor
    of the same type on `device` (None means "cuda"): float32, int8, or
    bfloat16.  numpy holds the reference's bfloat16 as an ``ml_dtypes``
    array, which ``torch.from_numpy`` refuses, so its 16-bit patterns are
    carried over as uint16 and viewed as torch.bfloat16."""
    u = np.array(u_pad, order="C")
    if u.ndim != 2:
        raise ValueError(f"expected a 2-D operand, got shape {u.shape}")
    if u.dtype in (np.float32, np.int8):
        t = torch.from_numpy(u)
    elif u.dtype.name == "bfloat16" and u.dtype.itemsize == 2:
        t = torch.from_numpy(u.view(np.uint16)).view(torch.bfloat16)
    else:
        raise ValueError(f"expected a float32, bfloat16 or int8 operand, got "
                         f"{u.dtype}")
    return t.to(resolve_device(device))


__all__ = ["plan_from_reference", "operand_from_reference"]
