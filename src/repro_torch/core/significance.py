"""Permutation and bootstrap significance: ``corr(x, pvalues=...)``.

Port of ``repro/core/significance.py``, on one device or over a mesh.  The
paper motivates
LightPCC with permutation testing (SSIV: >= 1,000 iterations per dataset):

    r, p = corr(x, pvalues=PermutationSpec(iterations=1000, key=0))

Replica axis.  Iteration b reorders the samples of the *column* operand by
pi_b; R_b = U pi_b(V)^T is then a plain all-pairs workload over the same row
operand.  One launch of the tile kernel covers a chunk of replicas: the
stacked (R, cols_pad, l_pad) column operand is the kernel's replica mode
(kernels/pcc_tile.py), on the triangle and on the rectangular grid.

Replica operands.  Measures whose row transform commutes with a sample
permutation (``Measure.permute_gather``) gather columns of the prepared
operand; quantized operands gather their codes and reuse the one scale
vector (the absmax of a row does not change under a permutation).
Bootstrap resampling and Kendall's pair expansion re-transform the
reordered raw data instead, and re-quantize each replica.

Random numbers.  ``jax.random`` cannot be reproduced in torch, so the port
draws all B index rows up front on the host, from one CPU
``torch.Generator`` seeded with ``key``, in iteration order:
``torch.randperm`` for "permute", ``torch.randint(0, l)`` for "bootstrap".
The same key gives the same null on the CPU and on the card, and chunks
slice the sequence, so p does not depend on ``chunk`` (nor on the pass
split).  ``PermutationSpec(indices=...)`` hands in the (B, l) index rows
instead (the reference's own permutations, in the parity tests).  The
p-value plan's measure name carries a digest of the indices, so two
results share a name exactly when they share a null.

Exceedance.  p(i, j) = (1 + #{b : |R_b| >= |R|}) / (1 + B), both sides
finalised (epilogue, then the bounded-measure clip).  Counts accumulate in
int32 on the device, pass by pass, and stream through an ExceedanceSink
into any inner sink.  Peak device memory beyond the operands is one pass's
observed tiles and counts plus one replica chunk's stack and its
(R, pass_tiles, t, t) output.

Mesh.  Over a mesh (``mesh=``) every rank launches its own tiles of a pass
on its stream (core/allpairs.MeshRun): the observed launch, then the
replica chunks, each stack built once a pass and copied to each device;
r and the counts reach the sinks as per-rank pieces.  p is bitwise the
one-device run's.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Optional, Union

import numpy as np
import torch

from repro_torch.core import measures, quantize
from repro_torch.core.allpairs import MeshRun, _ready_event, check_mesh
from repro_torch.core.plan import ExecutionPlan, launch_operand, \
    needs_row_scales
from repro_torch.core.quantize import Operand, operand_parts
from repro_torch.core.sinks import DenseSink, ExceedanceSink, TileSink
from repro_torch.kernels.pcc_tile import pcc_tiles
from repro_torch.runtime import faults

KeyLike = Union[int, torch.Generator]

METHODS = ("permute", "bootstrap")
_FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)


@dataclasses.dataclass(frozen=True, eq=False)
class PermutationSpec:
    """What null distribution to test against (``corr(pvalues=...)``).

    iterations: number of null replicas B (paper SSIV: >= 1,000; the
                add-one estimator floors p at 1/(B+1)).
    key:        int seed or CPU torch.Generator, required unless `indices`
                is given: a silent fixed seed would make repeated
                "independent" runs draw identical nulls.
    method:     "permute" draws a sample permutation per iteration (exact
                null: samples exchangeable under H0); "bootstrap" a
                with-replacement resample (always re-transforms).
    chunk:      replicas per kernel launch, a device-memory knob (default
                plan.DEFAULT_REPLICA_CHUNK); p does not depend on it.
    sink:       optional inner TileSink for the p-value tiles (wrapped in an
                ExceedanceSink); default a dense device matrix.
    indices:    optional (B, l) integer array or tensor: row b holds
                iteration b's sample indices (a permutation for "permute",
                values in [0, l) for "bootstrap") and replaces the draw.
    """

    iterations: int
    key: Optional[KeyLike] = None
    method: str = "permute"
    chunk: Optional[int] = None
    sink: Optional[TileSink] = None
    indices: Optional[object] = None

    def __post_init__(self):
        if self.iterations <= 0:
            raise ValueError(
                f"iterations must be positive, got {self.iterations}")
        if self.key is None and self.indices is None:
            raise ValueError(
                "PermutationSpec requires an explicit key: a fixed default "
                "seed would make repeated 'independent' runs draw identical "
                "null permutations.  Pass key=<int seed> or a torch "
                "Generator, or indices= with the index rows themselves.")
        if self.key is not None and (
                isinstance(self.key, bool)
                or not isinstance(self.key, (int, np.integer,
                                             torch.Generator))):
            raise ValueError(f"key must be an int seed or a CPU "
                             f"torch.Generator, got {type(self.key)}")
        if self.method not in METHODS:
            raise ValueError(
                f"method must be one of {METHODS}, got {self.method!r}")
        if self.chunk is not None and self.chunk <= 0:
            raise ValueError(f"chunk must be positive, got {self.chunk}")


def iteration_indices(spec: PermutationSpec, l: int) -> torch.Tensor:
    """(B, l) int64 CPU tensor: row b is iteration b's sample indices.

    Given ``spec.indices``, they are validated and returned.  Otherwise all B
    rows are drawn in iteration order from one CPU generator (``spec.key``
    itself, or one seeded with it): ``randperm(l)`` per row for "permute",
    ``randint(0, l, (l,))`` for "bootstrap".
    """
    b = spec.iterations
    if spec.indices is not None:
        idx = torch.as_tensor(spec.indices)
        if tuple(idx.shape) != (b, l) or idx.is_floating_point() or \
                idx.is_complex() or idx.dtype == torch.bool:
            raise ValueError(f"indices must be a ({b}, {l}) integer array, "
                             f"got {idx.dtype} {tuple(idx.shape)}")
        idx = idx.to(device="cpu", dtype=torch.int64).contiguous()
        if bool((idx < 0).any()) or bool((idx >= l).any()):
            raise ValueError(f"indices must lie in [0, {l})")
        if spec.method == "permute" and not torch.equal(
                torch.sort(idx, dim=1).values,
                torch.arange(l).expand(b, l)):
            raise ValueError("method 'permute' needs every index row to be "
                             "a permutation of range(l)")
        return idx
    if isinstance(spec.key, torch.Generator):
        if spec.key.device.type != "cpu":
            raise ValueError("key must be a CPU torch.Generator")
        gen = spec.key
    else:
        gen = torch.Generator().manual_seed(int(spec.key))
    out = torch.empty((b, l), dtype=torch.int64)
    for i in range(b):
        out[i] = (torch.randperm(l, generator=gen) if spec.method == "permute"
                  else torch.randint(0, l, (l,), generator=gen))
    return out


def indices_fingerprint(indices: torch.Tensor) -> str:
    """Short stable digest of a (B, l) index array: names the null."""
    data = indices.to(torch.int64).contiguous().numpy().astype("<i8")
    return hashlib.sha1(data.tobytes()).hexdigest()[:12]


def pvalue_measure(plan: ExecutionPlan, spec: PermutationSpec,
                   indices: torch.Tensor) -> measures.Measure:
    """Identity pseudo-measure naming the p-value output: base measure,
    method, B and the digest of the index rows, so a p-value result can
    never pass for an r result or for another null's p-values."""
    name = (f"{plan.measure.name}:pvalues:{spec.method}:"
            f"B{spec.iterations}:{indices_fingerprint(indices)}")
    return measures.Measure(name, measures.identity_transform, None, None)


def replica_operand(plan: ExecutionPlan, indices: torch.Tensor, *,
                    method: str, columns: torch.Tensor, cols_prepared):
    """Stacked column-operand variants of one replica chunk:
    (R, cols_pad, l_pad) for the R rows of `indices`, or an Operand with
    (R, cols_pad) scales when the plan quantizes.

    Gather path ("permute" on a permute_gather measure): each replica gathers
    sample columns of the prepared operand, padding columns kept in place;
    quantized codes are gathered and the one scale vector is expanded over R
    (stride 0).  Otherwise each replica re-transforms the reordered raw
    `columns` at float32, then narrows or re-quantizes, then pads.  fp8
    codes are gathered and copied as their bytes.
    """
    cols_data, cols_scale = operand_parts(cols_prepared)
    cols_pad, l_pad = cols_data.shape
    dev = cols_data.device
    raw = torch.uint8 if cols_data.dtype in _FP8 else cols_data.dtype
    reps = indices.shape[0]
    idx = indices.to(dev)
    if method == "permute" and plan.measure.permute_gather:
        tail = torch.arange(plan.l, l_pad, device=dev)
        src = cols_data.view(raw)
        stack = torch.empty((reps, cols_pad, l_pad), dtype=raw, device=dev)
        for r in range(reps):
            torch.index_select(src, 1, torch.cat([idx[r], tail]),
                               out=stack[r])
        stack = stack.view(cols_data.dtype)
        if cols_scale is None:
            return stack
        return Operand(stack, cols_scale.expand(reps, cols_pad))
    quantized = needs_row_scales(plan.measure, plan.compute_dtype)
    rows = columns.shape[0]
    stack = torch.zeros((reps, cols_pad, l_pad), dtype=raw, device=dev)
    scales = (torch.zeros((reps, cols_pad), dtype=torch.float32, device=dev)
              if quantized else None)
    for r in range(reps):
        ub = plan.measure.transform(torch.index_select(columns, 1, idx[r]),
                                    dtype=torch.float32)
        if quantized:
            ub, scales[r, :rows] = quantize.quantize_rows(ub,
                                                          plan.compute_dtype)
        elif plan.compute_dtype is not None:
            ub = ub.to(plan.compute_dtype)
        stack[r, :rows, :ub.shape[1]] = ub.view(raw)
    stack = stack.view(cols_data.dtype)
    return stack if scales is None else Operand(stack, scales)


def _cmp_vals(plan: ExecutionPlan, raw: torch.Tensor) -> torch.Tensor:
    """|finalised| values for the exceedance comparison: the epilogue and
    the bounded-measure clip on the raw accumulator (clipping both sides of
    >= at one bound never changes the outcome)."""
    return torch.abs(plan.measure.finalize(raw, plan.l, clip=plan.clip))


def _obs_tiles(plan: ExecutionPlan, raw: torch.Tensor) -> torch.Tensor:
    """The plain executor's tile stream rebuilt from the raw accumulator,
    bit for bit: the fused kernel applies EpilogueSpec.apply's arithmetic
    in registers, the unfused stream applies the measure's epilogue to the
    pass buffer (the clip then happens in the sink)."""
    if plan.fused:
        if plan.epilogue_spec is None or plan.epilogue_spec.is_identity():
            return raw
        return plan.epilogue_spec.apply(raw)
    if plan.measure.epilogue is not None:
        return plan.measure.epilogue(raw, plan.l)
    return raw


def run_significance(
    plan: ExecutionPlan,
    spec: PermutationSpec,
    u_pad,
    *,
    columns: torch.Tensor,
    v_pad=None,
    sink: Optional[TileSink] = None,
    mesh=None,
    shard_u: bool = False,
    replica_source: Optional[Callable[[int, torch.Tensor], object]] = None,
):
    """Execute a significance plan end to end; returns (r, p) results.

    plan carries the replica axis (ExecutionPlan.create(replicas=B,
    replica_chunk=...)); u_pad is the prepared row operand, v_pad the
    prepared column operand of a rectangular plan (None: the replicas
    reorder U itself); `columns` is the raw column-side data, which the
    re-transform path reads.  `sink` receives the observed r tiles (default
    DenseSink), spec.sink the p-value tiles through an ExceedanceSink.
    replica_source(chunk_index, index_rows) may replace the chunk stacks
    (the serving layer's null-state seam) and must return what
    replica_operand would.

    Per pass: one raw launch gives r (bitwise what ``corr`` computes) and
    the observed |values|; one replica launch per chunk gives the null
    tiles, compared replica by replica into int32 counts on the device.
    Each launched pass first passes the ``pass_launch`` fault site
    (runtime/faults.py), as the reference's does; a crashed run restarts
    with resumable sinks (``HostSink(path=, resume=True)``), whose held
    passes are not launched for their leg.  Over a mesh (its size
    ``plan.p``; shard_u row-shards U over it) each rank launches its own
    tiles of every pass.
    """
    check_mesh(mesh)
    if plan.replicas != spec.iterations:
        raise ValueError(
            f"plan.replicas={plan.replicas} does not match "
            f"spec.iterations={spec.iterations}: build the plan with "
            f"ExecutionPlan.create(replicas=spec.iterations, ...)")
    indices = iteration_indices(spec, plan.l)
    cols_prepared = u_pad if v_pad is None else v_pad
    # int16 operands (exact +/-1/0 signs) run the int8 kernels
    u_data, u_scale = operand_parts(launch_operand(u_pad))
    v_scale = (operand_parts(launch_operand(v_pad))[1]
               if v_pad is not None else None)
    if v_pad is not None and (u_scale is None) != (v_scale is None):
        raise ValueError("quantized row operand paired with an unquantized "
                         "column operand: both sides must be prepared by "
                         "the same plan")
    device = u_data.device
    # one rank on u's device without a mesh
    run = MeshRun(plan, mesh, launch_operand(u_pad),
                  None if v_pad is None else launch_operand(v_pad), shard_u)

    def rep_parts(reps):
        rep_data, rep_scale = operand_parts(launch_operand(reps))
        if (u_scale is None) != (rep_scale is None):
            raise ValueError(
                f"replica stack quantization does not match the row "
                f"operand: a replica_source must return an Operand with "
                f"(R, cols_pad) scales exactly when the plan quantizes "
                f"(plan.compute_dtype={plan.compute_dtype})")
        return rep_data, rep_scale

    if replica_source is None:
        def replica_source(ci: int, idx_c: torch.Tensor):
            del ci
            return replica_operand(plan, idx_c, method=spec.method,
                                   columns=columns,
                                   cols_prepared=cols_prepared)

    chunks, lo = [], 0
    for rc in plan.replica_chunk_sizes:
        chunks.append(indices[lo:lo + rc])
        lo += rc

    def launch(u, j0, tiles, v, col_scale):
        u_d, u_s = operand_parts(u)
        return pcc_tiles(u_d, j0, t=plan.t, l_blk=plan.l_blk,
                         pass_tiles=tiles, epilogue=None, v_pad=v,
                         grid_cols=plan.workload.grid_cols,
                         row_scale=u_s, col_scale=col_scale)

    def count(rep, abs_obs, counts):
        """counts += one chunk's exceedances, replica by replica."""
        for r in range(rep.shape[0]):
            counts += _cmp_vals(plan, rep[r]) >= abs_obs

    r_sink = sink if sink is not None else DenseSink()
    r_sink.open(plan, device)
    p_plan = dataclasses.replace(
        plan, measure=pvalue_measure(plan, spec, indices), fused=False,
        clip=False, epilogue_spec=None)
    p_sink = ExceedanceSink(inner=spec.sink)
    p_sink.open(p_plan, device)
    k0_r = getattr(r_sink, "resume_pass", lambda: 0)()
    k0_p = p_sink.resume_pass()
    skip_r = getattr(r_sink, "skip_passes", set)()
    skip_p = p_sink.skip_passes()
    r_done = getattr(r_sink, "pass_complete", lambda k: None)

    for k in range(min(k0_r, k0_p), plan.n_pass):
        need_r = k >= k0_r and k not in skip_r
        need_p = k >= k0_p and k not in skip_p
        if not (need_r or need_p):
            continue
        faults.check("pass_launch")
        _significance_pass(plan, run, k, need_r, need_p, launch, count,
                           chunks, rep_parts, replica_source, r_sink, r_done,
                           p_sink)
    return r_sink.result(), p_sink.result()


def _significance_pass(plan: ExecutionPlan, run: MeshRun, k: int,
                       need_r: bool, need_p: bool, launch, count, chunks,
                       rep_parts, replica_source, r_sink, r_done,
                       p_sink) -> None:
    """Pass k of a significance run: each rank's observed launch, its r
    piece handed on at once (pass k of r committed after the last), then,
    chunk by chunk (one stack built, copied to each device), each rank's
    replica launch, the stack dropped, each rank's comparisons into its
    counts, and its count piece (pass k of p committed)."""
    run.next_pass()
    slots = list(run.slots(k))
    cmp_, counts = {}, {}
    for r, d, start, n_tiles in slots:
        with run.on_rank(r) as (u, v):
            # symmetric runs reuse the row scales for the columns
            v_d, v_s = (operand_parts(v) if v is not None
                        else (None, operand_parts(u)[1]))
            raw = launch(u, start, n_tiles, v_d, v_s)
            obs = _obs_tiles(plan, raw) if need_r else None
            ready = _ready_event(d)
        if need_r:
            # before the comparison values are made, so the sink's work
            # on the piece is queued early and can end, freeing it, before
            # the replica stack and tiles (the pass's peak) are allocated
            r_sink.consume(np.arange(start, start + n_tiles,
                                     dtype=np.int64), obs, ready)
        del obs
        if need_p:
            with run.on_rank(r):
                cmp_[r] = _cmp_vals(plan, raw)
                counts[r] = torch.zeros(raw.shape, dtype=torch.int32,
                                        device=d)
    if need_r:
        r_done(k)
    if not need_p:
        return
    for ci in range(len(chunks)):
        rep_data, rep_scale = rep_parts(replica_source(ci, chunks[ci]))
        on = {d: tuple(None if a is None else a.to(d)
                       for a in (rep_data, rep_scale))
              for d in run.devices}
        del rep_data, rep_scale
        reps = {}
        for r, d, start, n_tiles in slots:
            with run.on_rank(r, *(a for a in on[d] if a is not None)) \
                    as (u, _v):
                reps[r] = launch(u, start, n_tiles, *on[d])
        # the stacks go once their launches are queued (the streams order
        # their reuse), before the comparisons' temporaries are made: no
        # local names a stack, so one chunk's is live at a time and not
        # beside those temporaries
        del on
        for r, _d, _start, _n in slots:
            with run.on_rank(r):
                count(reps.pop(r), cmp_[r], counts[r])
    for r, d, start, n_tiles in slots:
        with run.on_rank(r):
            ready = _ready_event(d)
        p_sink.consume(np.arange(start, start + n_tiles, dtype=np.int64),
                       counts.pop(r), ready)
    p_sink.pass_complete(k)


def dense_significance_reference(x, y=None, *,
                                 measure: measures.MeasureLike = "pearson",
                                 spec: PermutationSpec, clip: bool = True):
    """Dense oracle of the engine's (r, p) in plain torch, on x's device:
    the same index rows, the same replica semantics (gather or re-transform),
    the same finalised comparison and the same canonical symmetric output
    (the upper triangle mirrored elementwise)."""
    meas = measures.get(measure)
    x = torch.as_tensor(x)
    src = x if y is None else torch.as_tensor(y, device=x.device)
    l = x.shape[1]
    u = meas.transform(x, dtype=torch.float32)
    v = u if y is None else meas.transform(src, dtype=torch.float32)
    r = meas.finalize(u @ v.T, l, clip=clip)
    abs_obs = r.abs()
    counts = torch.zeros(r.shape, dtype=torch.int32, device=x.device)
    for idx in iteration_indices(spec, l).to(x.device):
        if spec.method == "permute" and meas.permute_gather:
            vb = v[:, idx]
        else:
            vb = meas.transform(src[:, idx], dtype=torch.float32)
        counts += meas.finalize(u @ vb.T, l, clip=clip).abs() >= abs_obs
    den = torch.tensor(1.0 + spec.iterations, dtype=torch.float32,
                       device=x.device)
    p = (1.0 + counts.to(torch.float32)) / den
    if y is None:
        upper = torch.ones_like(p, dtype=torch.bool).triu_()
        p = torch.where(upper, p, p.T)
    return r, p


__all__ = [
    "METHODS",
    "PermutationSpec",
    "iteration_indices",
    "indices_fingerprint",
    "pvalue_measure",
    "replica_operand",
    "run_significance",
    "dense_significance_reference",
]
