"""`corr()`: the problem-centric facade.

Port of ``repro/core/api.py``: symmetric all-pairs similarity of one
(n, l) operand and the rectangular X-vs-Y workload, on one device or over
a mesh of ranks (``mesh=``, ``shard_u=``),
under every inner-product measure and merge-sort Kendall at l >= 96
(its own tile kernel), with float32, bfloat16, int8 or fp8
stored operands (int8 on non-Kendall measures and fp8 quantized with
per-row scales), pairwise-complete masked runs (``where=``),
permutation / bootstrap p-values (``pvalues=``), resumable host output
(``sink=HostSink(path=)``, ``resume_from=``) and self-healing execution
(``recovery=RetryPolicy()``).  A frozen
:class:`PairwiseProblem` captures what is asked; :func:`corr` resolves it
onto plan -> executor -> sink, preparing every unmasked operand through the
process-wide :class:`TransformCache`.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Callable, Optional

import torch

from repro_torch.core import measures
from repro_torch.core.allpairs import _stream, check_mesh, execute_plan, \
    resolve_device, run_sink
from repro_torch.core.lru import LruStatsCache
from repro_torch.core.plan import ExecutionPlan, pad_operands
from repro_torch.core.quantize import operand_data
from repro_torch.core.significance import PermutationSpec, run_significance
from repro_torch.core.sinks import HostSink, TileSink, after
from repro_torch.kernels.pcc_tile import DEFAULT_LBLK, DEFAULT_TILE, \
    dtype_name


class TransformCache(LruStatsCache):
    """Memoises prepared operands (row transform, narrowing or
    quantization, padding) per operand tensor.

    The measure's row transform is the only per-operand device work of a
    run (epilogues fuse into the kernel); re-running it for an operand the
    process has already prepared is waste.  ``corr()`` routes every
    unmasked operand through the process-wide instance.

    Keys are the operand's identity and its in-place version counter
    (``x._version``), plus the transform's parameters: the plan's resolved
    measure (kendall at l >= 96 with no compute_dtype is KENDALL_MERGE,
    whose operand is ranks; with int8 it stays KENDALL, pair signs), compute
    dtype (a ``torch.dtype`` and its name are one key), tile alignment.
    A torch tensor, unlike a jax array, can change in place: the version
    counter makes a changed tensor miss, and the entry of its older
    version is dropped.  Writes that bypass torch do not move the counter
    (through a numpy view of a CPU tensor, ``torch.from_numpy``'s array,
    or DLPack): call :func:`clear_prepared_cache` after them.

    Only tensors the caller handed over are cached, and an entry holds
    only a weak reference to its operand: when the caller drops the
    tensor, its entry evicts itself (weakref death callback), so the cache
    never extends an operand's lifetime, and a recycled ``id()`` cannot
    alias a dead entry (an identity check on lookup guards the race).  A
    prepared value that shares the operand's storage (an identity
    transform with no padding) is not cached: it would keep the operand
    alive, and costs nothing to rebuild.  Host numpy inputs, which convert
    to a fresh tensor per call, bypass the cache
    (``prepared_operand(cacheable=False)``).

    Inference tensors (made under ``torch.inference_mode()``) have no
    version counter, so an in-place change to one could not be seen: their
    operands are built uncached, as non-tensor operands are, never keyed
    by ``id`` alone.  A multi-pass merge-sort Kendall run on such a tensor
    then also rebuilds its rank structures at each launch
    (kernels/kendall_merge.py keys them by the same counter; about 2.2 ms
    a launch at 1,639 x 5,072 on an H100).

    Bounded LRU; thread-safe.
    """

    def __init__(self, capacity: int = 8):
        super().__init__(capacity)

    @staticmethod
    def _key(x: torch.Tensor, measure: measures.Measure, compute_dtype,
             t: int, l_blk: int) -> tuple:
        cd = None if compute_dtype is None else dtype_name(compute_dtype)
        return (id(x), x._version, id(measure), cd, int(t), int(l_blk))

    def prepared(self, x: torch.Tensor, measure: measures.Measure,
                 compute_dtype, t: int, l_blk: int, build: Callable):
        """The prepared operand (a tensor or a quantized ``Operand``) for
        (x, measure, compute_dtype, t, l_blk), built by ``build()`` on a
        miss.  Non-tensor operands and inference tensors are built
        uncached."""
        if not isinstance(x, torch.Tensor) or x.is_inference():
            return build()
        key = self._key(x, measure, compute_dtype, t, l_blk)
        entry = self._lookup(key)
        if entry is not None and entry[0]() is x and entry[1] is measure:
            return entry[2]
        # build outside the lock: transforms queue device work
        value = build()
        data = operand_data(value)
        if data.untyped_storage().data_ptr() == \
                x.untyped_storage().data_ptr():
            return value
        ref = weakref.ref(x, lambda _, k=key: self._evict(k))
        with self._lock:
            stale = [k for k in self._entries
                     if k[0] == key[0] and k[2:] == key[2:] and k != key]
        for k in stale:
            self._evict(k)
        self._insert(key, (ref, measure, value))
        return value


_PREPARED = TransformCache()


def prepared_operand(plan: ExecutionPlan, x: torch.Tensor, *,
                     cache: Optional[TransformCache] = None,
                     expect_rows: Optional[int] = None,
                     cacheable: bool = True):
    """``plan.prepare(x)`` through a transform cache (default: the
    process-wide one ``corr()`` uses).  expect_rows overrides the row-count
    check for rectangular column operands (the prepared operand depends
    only on the measure, dtype and alignment, so entries are shared across
    workload shapes).  cacheable=False skips the cache: ``corr()`` passes
    it for operands it had to convert or move (host numpy, another
    device), which are a fresh tensor every call."""
    rows = plan.n_rows if expect_rows is None else expect_rows
    if tuple(x.shape) != (rows, plan.l):
        raise ValueError(
            f"operand shape {tuple(x.shape)} does not match plan "
            f"(rows={rows}, l={plan.l})")
    if not cacheable:
        return plan._prepare_one(x)
    c = cache if cache is not None else _PREPARED
    return c.prepared(x, plan.measure, plan.compute_dtype, plan.t,
                      plan.l_blk, build=lambda: plan._prepare_one(x))


def clear_prepared_cache() -> None:
    """Drop every cached prepared operand (tests; memory pressure)."""
    _PREPARED.clear()


def prepared_cache_stats() -> dict:
    return _PREPARED.stats()


def _on_device(a, dev: torch.device) -> torch.Tensor:
    """a as a tensor on dev: the caller's own object when it already lies
    there (so the transform cache can recognise it), else a new tensor."""
    if isinstance(a, torch.Tensor) and a.device.type == dev.type and \
            dev.index in (None, a.device.index):
        return a
    return torch.as_tensor(a, device=dev)


def _as_mask(mask, data: torch.Tensor, side: str) -> torch.Tensor:
    m = torch.as_tensor(mask, device=data.device)
    if tuple(m.shape) != tuple(data.shape):
        raise ValueError(
            f"where mask for {side} has shape {tuple(m.shape)}, expected "
            f"{tuple(data.shape)}")
    return m.to(torch.bool)


@dataclasses.dataclass(frozen=True, eq=False)
class PairwiseProblem:
    """What is being asked: x (n_rows, l) and optional y (n_cols, l) under a
    resolved measure; y=None is the symmetric all-pairs workload over x.
    mask_x / mask_y are boolean validity masks (True = sample present), or
    None for fully observed data."""

    x: torch.Tensor
    y: Optional[torch.Tensor]
    measure: measures.Measure
    mask_x: Optional[torch.Tensor] = None
    mask_y: Optional[torch.Tensor] = None

    @property
    def symmetric(self) -> bool:
        return self.y is None

    @property
    def masked(self) -> bool:
        return self.mask_x is not None

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
               where=None, device=None) -> "PairwiseProblem":
        """x and y may be numpy arrays or tensors; they move to `device`
        (a tensor already there is kept as the same object).

        where: None (unmasked), "nan" (validity from NaNs), a boolean array
        or tensor masking x (symmetric problems), or an (x_mask, y_mask)
        tuple for rectangular ones (either None to infer from NaNs).
        """
        dev = resolve_device(device)
        x = _on_device(x, dev)
        if x.ndim != 2:
            raise ValueError(f"x must be (n, l), got shape {tuple(x.shape)}")
        if y is not None:
            y = _on_device(y, dev)
            if y.ndim != 2 or y.shape[1] != x.shape[1]:
                raise ValueError(f"y must be (n_cols, l={x.shape[1]}), got "
                                 f"shape {tuple(y.shape)}")
        meas = measures.get(measure)
        mask_x = mask_y = None
        if where is not None:
            # fails fast for measures with no pairwise-complete form
            measures.get_masked(meas)
            if isinstance(where, str):
                if where != "nan":
                    raise ValueError(
                        f"where={where!r} not understood; pass a boolean "
                        f"mask, an (x_mask, y_mask) tuple, or 'nan'")
                mask_x = ~torch.isnan(x)
                mask_y = None if y is None else ~torch.isnan(y)
            elif isinstance(where, tuple):
                wx, wy = where
                mask_x = (~torch.isnan(x) if wx is None
                          else _as_mask(wx, x, "x"))
                if y is None:
                    if wy is not None:
                        raise ValueError(
                            "symmetric problem (y=None) takes a single "
                            "mask, not an (x_mask, y_mask) tuple")
                else:
                    mask_y = (~torch.isnan(y) if wy is None
                              else _as_mask(wy, y, "y"))
            else:
                if y is not None:
                    raise ValueError(
                        "rectangular masked problems need masks for both "
                        "sides: pass where=(x_mask, y_mask) (either may be "
                        "None to infer from NaNs)")
                mask_x = _as_mask(where, x, "x")
        return cls(x=x, y=y, measure=meas, mask_x=mask_x, mask_y=mask_y)


def corr(x, y=None, *, measure: measures.MeasureLike = "pearson",
         sink: Optional[TileSink] = None, t: int = DEFAULT_TILE,
         l_blk: int = DEFAULT_LBLK, max_tiles_per_pass: Optional[int] = None,
         clip: bool = True, fuse_epilogue: bool = True, device=None,
         where=None, mesh=None, shard_u: bool = False, compute_dtype=None,
         resume_from: Optional[str] = None,
         pvalues: Optional[PermutationSpec] = None, recovery=None):
    """All-pairs similarity: plan -> executor -> sink.

    x:       (n, l) variables, numpy array or tensor.
    y:       optional (n_cols, l) second operand: the rectangular X-vs-Y
             workload, every x row against every y row.
    measure: a registered name or Measure (core/measures.py): "pearson"
             ("pcc"), "spearman", "cosine", "covariance" ("cov"), "dot",
             "kendall" ("kendall_tau_a"), "kendall_tau_b" ("kendall_b"),
             "kendall_sign_gemm", "kendall_tau_b_sign_gemm",
             "kendall_merge", "kendall_tau_b_merge", or one added with
             measures.register.  kendall / kendall_tau_b at l >= 96
             without compute_dtype or pvalues take the merge-sort kernel
             (kernels/kendall_merge.py: the (n, l) ranks as operand,
             Knight's O(l log l) count per pair, tau-a bitwise the
             sign-GEMM's; on the card l <= 16,384); DeviceTopKSink refuses
             it, TopKSink and the other sinks take its tiles.
    where:   pairwise-complete scoring of missing data: "nan" takes
             validity from NaNs; a boolean array or tensor masks x
             (symmetric problems); an (x_mask, y_mask) tuple masks both
             sides of a rectangular problem (either None: from NaNs).  Each
             pair is scored over its common valid samples through the
             measure's component products (pearson, cosine, covariance);
             pairs with fewer than 2 common samples or zero variance on
             them score 0.  Not with compute_dtype.
    compute_dtype: None keeps the transform's float32 operands;
             torch.bfloat16 / "bfloat16" stores them in bf16 (float32
             accumulation); torch.int8 / "int8" stores kendall's integer
             pair signs as they are (int32 accumulation, bitwise the
             float32 result) and quantizes every other measure's rows with
             per-row absmax scales, as torch.float8_e4m3fn and
             torch.float8_e5m2 do for every measure (core/quantize.py; the
             kernel multiplies each tile by the scale product).
    sink:    output handling; the default DenseSink returns the (n, n)
             float32 matrix on `device`, exactly symmetric (or the
             (n, n_cols) cross matrix when y is given).  HostSink()
             returns the same matrix as a host numpy array (HostSink(out=)
             a caller array, HostSink(path=) an np.memmap committed pass
             by pass, resumable).  TopKSink(k) and
             DeviceTopKSink(k) keep each row's k strongest partners, the
             latter through the top-k kernel (not for masked or quantized
             runs).  EdgeCountSink(threshold, labels=) counts the
             thresholded network's edges and degrees on the device (O(n)
             state, symmetric runs); ReductionSink(fn, init) folds the
             tile stream through a host callback; RowBlockSink(bounds)
             lands row ranges of a rectangular run in their own host
             arrays.
    x and y given as tensors on `device` have their prepared operands
             cached (TransformCache, keyed by the tensor and its in-place
             version): a repeat call skips the row transform.  After
             changing such a tensor behind torch's back (a numpy view),
             call clear_prepared_cache().
    t / l_blk / max_tiles_per_pass / clip / fuse_epilogue keep their
             ExecutionPlan semantics; the result does not depend on
             max_tiles_per_pass or fuse_epilogue, bit for bit.
    pvalues: a PermutationSpec (core/significance.py) turns the run into a
             significance test: returns (r, p), r exactly what the call
             without pvalues returns and p the add-one permutation (or
             bootstrap) p-values over spec.iterations null replicas, in
             the output layout of spec.sink (default dense).  Not with
             where=.
    resume_from: the memmap path of an interrupted HostSink(path=) run
             with the same plan: the default sink becomes
             HostSink(path=resume_from, resume=True), which runs only the
             passes its checkpoint does not hold (and the regions whose
             CRC no longer matches); a HostSink of that path is switched
             to resume, any other sink refused.  Checkpoints of the
             reference package resume here and the other way round.
    recovery: a RetryPolicy (runtime/faults.py) arms the self-healing
             executor: transient failures retry in place with backoff, an
             out-of-memory error (injected, or torch.cuda's) halves the
             pass, a lost device goes to policy.on_device_loss (by
             default a mesh drops a device and repartitions onto the
             survivors; one device has none, so the loss propagates), and
             every
             attempt resumes from the tiles the sink holds; the recovered
             result is bitwise a fault-free run.  Crashes propagate (restart
             with resume_from=), and so does any other error: a kernel that
             fails to build or launch is never retried on a plain version.
             Not with where= or pvalues=, which drive their own pass loops.
    device:  None means "cuda", which raises on a machine without a card;
             pass device="cpu" to run the kernels' plain versions.  With a
             mesh, None means the mesh's first device, and any other
             device raises ValueError.
    mesh:    a launch.mesh.Mesh (make_mesh((p,), ("d",), devices=...)):
             its p ranks split the tile ids (paper SSIII-D), each launching
             its own tiles on a CUDA stream of its device; one process
             drives them all, the sink takes each pass rank by rank, and
             the result lies on the mesh's first device, bitwise the
             one-device run.  A lost device (recovery=) shrinks the mesh.
    shard_u: with a mesh, row-shard the operand over the ranks and gather
             it onto each device once a pass (symmetric runs, not with
             DeviceTopKSink or where=), as the reference's; without a mesh
             it changes nothing, as in the reference.
    """
    first = check_mesh(mesh, device)
    if first is not None:
        device = first
    if resume_from is not None:
        if sink is None:
            sink = HostSink(path=resume_from, resume=True)
        elif isinstance(sink, HostSink) and sink._path == resume_from:
            sink._resume = True
        else:
            raise ValueError(
                "resume_from requires the default HostSink or a HostSink "
                "whose path matches resume_from")
    problem = PairwiseProblem.create(x, y, measure=measure, where=where,
                                     device=device)
    if recovery is not None and (problem.masked or pvalues is not None):
        raise ValueError(
            "recovery= is supported for plain runs only (masked and "
            "pvalues workloads drive their own multi-stream pass loops); "
            "run those under a FaultPlan with resume_from= restart "
            "recovery instead")
    if problem.masked:
        if pvalues is not None:
            raise ValueError(
                "pvalues= is not supported with where=: a masked run has "
                "no single observed GEMM to permute (each pair's statistic "
                "combines several component GEMMs over its common support)")
        if compute_dtype is not None:
            raise ValueError(
                "compute_dtype narrowing is not supported with where= "
                "(component GEMMs accumulate counts and sums that must "
                "stay exact f32)")
        if shard_u:
            raise ValueError("shard_u is not supported with where= (the "
                             "component GEMMs are rectangular workloads)")
        return _run_masked(problem, sink=sink, mesh=mesh, t=t, l_blk=l_blk,
                           max_tiles_per_pass=max_tiles_per_pass, clip=clip)
    shard_u = bool(shard_u) and mesh is not None
    p = 1 if mesh is None else mesh.size
    plan = ExecutionPlan.create(
        problem.n_rows, problem.l,
        n_cols=None if problem.symmetric else problem.n_cols, t=t,
        l_blk=l_blk, measure=problem.measure, p=p,
        max_tiles_per_pass=max_tiles_per_pass, clip=clip,
        fuse_epilogue=fuse_epilogue, compute_dtype=compute_dtype,
        replicas=0 if pvalues is None else pvalues.iterations,
        replica_chunk=None if pvalues is None else pvalues.chunk)
    # the transform cache: repeat calls on the same tensor run the row
    # transform once.  problem.x is the caller's object only when it was a
    # tensor on the device; a converted or moved operand is a fresh tensor
    # per call and is not cached.
    u_pad = prepared_operand(plan, problem.x, cacheable=problem.x is x)
    if problem.symmetric:
        if pvalues is not None:
            return run_significance(plan, pvalues, u_pad, columns=problem.x,
                                    sink=sink, mesh=mesh, shard_u=shard_u)
        return execute_plan(plan, u_pad, sink=sink, device=problem.x.device,
                            mesh=mesh, shard_u=shard_u, recovery=recovery)
    v_pad = prepared_operand(plan, problem.y, expect_rows=problem.n_cols,
                             cacheable=problem.y is y)
    if pvalues is not None:
        return run_significance(plan, pvalues, u_pad, columns=problem.y,
                                v_pad=v_pad, sink=sink, mesh=mesh,
                                shard_u=shard_u)
    return execute_plan(plan, u_pad, v_pad, sink=sink,
                        device=problem.x.device, mesh=mesh, shard_u=shard_u,
                        recovery=recovery)


def masked_sink_plan(plan: ExecutionPlan, mm: measures.MaskedMeasure,
                     clip: bool) -> ExecutionPlan:
    """The plan a masked run's sink sees: the component plan under the
    masked measure's identity (name and clip), unfused, because the combine
    leaves values unclipped and the sink clips iff asked."""
    sink_measure = measures.Measure(mm.name, measures.identity_transform,
                                    None, mm.clip)
    return dataclasses.replace(plan, measure=sink_measure, fused=False,
                               clip=clip)


def _run_masked(problem: PairwiseProblem, *, sink, mesh, t, l_blk,
                max_tiles_per_pass, clip):
    """Masked execution: one stream of pass launches per component
    product, combined elementwise pass by pass on the device.

    All components share one plan (measure "dot", the same geometry), so
    their pass boundaries and tile ids line up and zipping the streams keeps
    device memory at two pass buffers per component.  Symmetric problems
    run every component on the triangle: sxy and n take the single-operand
    path; the cross terms come in transpose pairs (sy(i, j) = sx(j, i),
    qy(i, j) = qx(j, i)) that ride the triangle with a same-shape second
    operand, and every combine uses them only through commutative products,
    so the combined tile at (x, y) is the transpose of the one at (y, x) and
    the sink's mirror completes the matrix.  Over a mesh the components'
    pieces line up rank by rank and combine on each rank's device.
    """
    mm = measures.get_masked(problem.measure)
    ops_x = measures.masked_operands(problem.x, problem.mask_x)
    ops_y = (ops_x if problem.symmetric
             else measures.masked_operands(problem.y, problem.mask_y))
    plan = ExecutionPlan.create(
        problem.n_rows, problem.l,
        n_cols=None if problem.symmetric else problem.n_cols, t=t,
        l_blk=l_blk, measure="dot", p=1 if mesh is None else mesh.size,
        max_tiles_per_pass=max_tiles_per_pass, clip=False)
    pad_x = {k: pad_operands(v, t, l_blk) for k, v in ops_x.items()}
    pad_y = (pad_x if ops_y is ops_x
             else {k: pad_operands(v, t, l_blk) for k, v in ops_y.items()})
    sink_plan = masked_sink_plan(plan, mm, clip)

    def combined(k0, skip):
        # The combine queues on the current stream of each piece's device,
        # after the components' launches, so the sink waits on everything
        # queued there (ready None).
        streams = []
        for comp in mm.components:
            rk, ck = measures.MASKED_COMPONENT_OPERANDS[comp]
            same = pad_y is pad_x and rk == ck
            streams.append(_stream(plan, pad_x[rk],
                                   None if same else pad_y[ck], k0, skip,
                                   mesh=mesh))
        for items in zip(*streams):
            k = items[0][0]
            pieces = []
            for rank_pieces in zip(*(its for _, its in items)):
                for _, buf, ready in rank_pieces:
                    after(ready, buf)
                parts = {c: buf for c, (_, buf, _) in zip(mm.components,
                                                          rank_pieces)}
                pieces.append((rank_pieces[0][0], mm.combine(parts), None))
            yield k, pieces

    return run_sink(sink_plan, sink, problem.x.device, combined)


__all__ = ["PairwiseProblem", "corr", "masked_sink_plan", "TransformCache",
           "prepared_operand", "prepared_cache_stats",
           "clear_prepared_cache"]
