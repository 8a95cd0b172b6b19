"""`corr()`: the problem-centric facade.

Port of ``repro/core/api.py`` for the paper's own workload — symmetric
all-pairs similarity of one (n, l) operand — and the rectangular X-vs-Y
workload, on one device, under every inner-product measure and with
float32, bfloat16 or int8 stored operands.  A frozen
:class:`PairwiseProblem` captures what is asked; :func:`corr` resolves it
onto plan -> executor -> sink.  The reference's other workloads and knobs
raise ``NotImplementedError`` naming the ROADMAP slice that brings them.
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
    "resume_from": "slice 4 (HostSink checkpoints)",
    "where": "slice 5 (masked measures)",
    "pvalues": "slice 8 (significance)",
    "recovery": "slice 10 (recovery)",
    "mesh": "slice 11 (multi-GPU)",
    "shard_u": "slice 11 (multi-GPU)",
}


@dataclasses.dataclass(frozen=True, eq=False)
class PairwiseProblem:
    """What is being asked: x (n_rows, l) and optional y (n_cols, l) under a
    resolved measure; y=None is the symmetric all-pairs workload over x."""

    x: torch.Tensor
    y: Optional[torch.Tensor]
    measure: measures.Measure

    @property
    def symmetric(self) -> bool:
        return self.y is None

    @property
    def n_rows(self) -> int:
        return self.x.shape[0]

    @property
    def n_cols(self) -> int:
        return (self.x if self.y is None else self.y).shape[0]

    @property
    def l(self) -> int:
        return self.x.shape[1]

    @classmethod
    def create(cls, x, y=None, *, measure: measures.MeasureLike = "pearson",
               device=None) -> "PairwiseProblem":
        """x and y may be numpy arrays or tensors; they move to `device`."""
        dev = resolve_device(device)
        x = torch.as_tensor(x, device=dev)
        if x.ndim != 2:
            raise ValueError(f"x must be (n, l), got shape {tuple(x.shape)}")
        if y is not None:
            y = torch.as_tensor(y, device=dev)
            if y.ndim != 2 or y.shape[1] != x.shape[1]:
                raise ValueError(f"y must be (n_cols, l={x.shape[1]}), got "
                                 f"shape {tuple(y.shape)}")
        return cls(x=x, y=y, measure=measures.get(measure))


def corr(x, y=None, *, measure: measures.MeasureLike = "pearson",
         sink: Optional[TileSink] = None, t: int = DEFAULT_TILE,
         l_blk: int = DEFAULT_LBLK, max_tiles_per_pass: Optional[int] = None,
         clip: bool = True, fuse_epilogue: bool = True, device=None,
         where=None, mesh=None, shard_u: bool = False, compute_dtype=None,
         resume_from: Optional[str] = None, pvalues=None, recovery=None):
    """All-pairs similarity: plan -> executor -> sink.

    x:       (n, l) variables, numpy array or tensor.
    y:       optional (n_cols, l) second operand: the rectangular X-vs-Y
             workload, every x row against every y row.
    measure: a registered name or Measure (core/measures.py): "pearson"
             ("pcc"), "spearman", "cosine", "covariance" ("cov"), "dot",
             "kendall" ("kendall_tau_a"), "kendall_tau_b" ("kendall_b"),
             "kendall_sign_gemm", "kendall_tau_b_sign_gemm", or one added
             with measures.register.  kendall / kendall_tau_b at l >= 96
             without compute_dtype take the reference's merge-sort kernel
             and raise NotImplementedError (ROADMAP slice 7).
    compute_dtype: None keeps the transform's float32 operands;
             torch.bfloat16 / "bfloat16" stores them in bf16 (float32
             accumulation), torch.int8 / "int8" in int8 for measures whose
             transform is integer-valued (kendall: int32 accumulation,
             bitwise the float32 result).  int8 on other measures and fp8
             are the reference's quantized path and raise
             NotImplementedError (ROADMAP slice 6).
    sink:    output handling; the default DenseSink returns the (n, n)
             float32 matrix on `device`, exactly symmetric (or the
             (n, n_cols) cross matrix when y is given).  TopKSink(k) and
             DeviceTopKSink(k) keep each row's k strongest partners, the
             latter through the top-k kernel.
    t / l_blk / max_tiles_per_pass / clip / fuse_epilogue keep their
             ExecutionPlan semantics; the result does not depend on
             max_tiles_per_pass or fuse_epilogue, bit for bit.
    device:  None means "cuda", which raises on a machine without a card;
             pass device="cpu" to run the kernels' plain versions.
    where, mesh, shard_u, resume_from, pvalues and recovery are the
    reference's and raise NotImplementedError here.
    """
    given = {"where": where is not None,
             "mesh": mesh is not None, "shard_u": bool(shard_u),
             "resume_from": resume_from is not None,
             "pvalues": pvalues is not None, "recovery": recovery is not None}
    for name, on in given.items():
        if on:
            raise NotImplementedError(
                f"corr({name}=...) is not ported yet: ROADMAP "
                f"{_LATER_SLICES[name]}")
    problem = PairwiseProblem.create(x, y, measure=measure, device=device)
    plan = ExecutionPlan.create(
        problem.n_rows, problem.l,
        n_cols=None if problem.symmetric else problem.n_cols, t=t,
        l_blk=l_blk, measure=problem.measure,
        max_tiles_per_pass=max_tiles_per_pass, clip=clip,
        fuse_epilogue=fuse_epilogue, compute_dtype=compute_dtype)
    if problem.symmetric:
        return execute_plan(plan, plan.prepare(problem.x), sink=sink,
                            device=problem.x.device)
    u_pad, v_pad = plan.prepare_pair(problem.x, problem.y)
    return execute_plan(plan, u_pad, v_pad, sink=sink,
                        device=problem.x.device)


__all__ = ["PairwiseProblem", "corr"]
