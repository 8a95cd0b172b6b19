"""`corr()`: the problem-centric facade, symmetric workload.

Port of ``repro/core/api.py`` for the paper's own workload: symmetric
all-pairs similarity of one (n, l) operand on one device into a dense n x n
result.  A frozen :class:`PairwiseProblem` captures what is asked;
:func:`corr` resolves it onto plan -> executor -> sink.  The reference's
other workloads and knobs raise ``NotImplementedError`` naming the ROADMAP
slice that brings them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import measures
from repro_torch.core.allpairs import execute_plan, resolve_device
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.sinks import TileSink
from repro_torch.kernels.pcc_tile import DEFAULT_LBLK, DEFAULT_TILE

# keyword of the reference's corr() -> ROADMAP slice that ports it
_LATER_SLICES = {
    "y": "slice 2 (rectangular X-vs-Y)",
    "compute_dtype": "slice 2 (bf16/int8 operands) and slice 6 (quantized)",
    "resume_from": "slice 3 (HostSink checkpoints)",
    "where": "slice 5 (masked measures)",
    "pvalues": "slice 8 (significance)",
    "recovery": "slice 10 (recovery)",
    "mesh": "slice 11 (multi-GPU)",
    "shard_u": "slice 11 (multi-GPU)",
}


@dataclasses.dataclass(frozen=True, eq=False)
class PairwiseProblem:
    """What is being asked: the symmetric all-pairs workload over x (n, l)
    under a resolved measure."""

    x: torch.Tensor
    measure: measures.Measure

    @property
    def symmetric(self) -> bool:
        return True

    @property
    def n_rows(self) -> int:
        return self.x.shape[0]

    @property
    def l(self) -> int:
        return self.x.shape[1]

    @classmethod
    def create(cls, x, *, measure: measures.MeasureLike = "pearson",
               device=None) -> "PairwiseProblem":
        """x may be a numpy array or a tensor; it moves to `device`."""
        dev = resolve_device(device)
        x = torch.as_tensor(x, device=dev)
        if x.ndim != 2:
            raise ValueError(f"x must be (n, l), got shape {tuple(x.shape)}")
        return cls(x=x, measure=measures.get(measure))


def corr(x, y=None, *, measure: measures.MeasureLike = "pearson",
         sink: Optional[TileSink] = None, t: int = DEFAULT_TILE,
         l_blk: int = DEFAULT_LBLK, max_tiles_per_pass: Optional[int] = None,
         clip: bool = True, fuse_epilogue: bool = True, device=None,
         where=None, mesh=None, shard_u: bool = False, compute_dtype=None,
         resume_from: Optional[str] = None, pvalues=None, recovery=None):
    """Symmetric all-pairs similarity of x's rows: plan -> executor -> sink.

    x:       (n, l) variables, numpy array or tensor.
    measure: "pearson" (the other measures are ROADMAP slice 2).
    sink:    output handling; the default DenseSink returns the (n, n)
             float32 matrix on `device`, exactly symmetric.
    t / l_blk / max_tiles_per_pass / clip / fuse_epilogue keep their
             ExecutionPlan semantics; the result does not depend on
             max_tiles_per_pass or fuse_epilogue, bit for bit.
    device:  None means "cuda", which raises on a machine without a card;
             pass device="cpu" to run the kernels' plain versions.
    y, where, mesh, shard_u, compute_dtype, resume_from, pvalues and
    recovery are the reference's and raise NotImplementedError here.
    """
    given = {"y": y is not None, "where": where is not None,
             "mesh": mesh is not None, "shard_u": bool(shard_u),
             "compute_dtype": compute_dtype is not None,
             "resume_from": resume_from is not None,
             "pvalues": pvalues is not None, "recovery": recovery is not None}
    for name, on in given.items():
        if on:
            raise NotImplementedError(
                f"corr({name}=...) is not ported yet: ROADMAP "
                f"{_LATER_SLICES[name]}")
    problem = PairwiseProblem.create(x, measure=measure, device=device)
    plan = ExecutionPlan.create(
        problem.n_rows, problem.l, t=t, l_blk=l_blk, measure=problem.measure,
        max_tiles_per_pass=max_tiles_per_pass, clip=clip,
        fuse_epilogue=fuse_epilogue)
    return execute_plan(plan, plan.prepare(problem.x), sink=sink,
                        device=problem.x.device)


__all__ = ["PairwiseProblem", "corr"]
