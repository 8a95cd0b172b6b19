"""The plan-driven all-pairs executor (symmetric or X-vs-Y, on one device
or over a mesh).

Port of ``repro/core/allpairs.py``:

    ExecutionPlan (core/plan.py)   what to run, decided once on the host
        |
    executor (this module)         iterate passes with double buffering:
        |                          pass k+1 is launched before the sink
        v                          touches pass k (paper Alg. 2)
    TileSink (core/sinks.py)       what becomes of the tiles

Kernel launches are asynchronous on the current CUDA stream.  Each pass
carries the CUDA event recorded right after its launch; the sink waits on
that event alone (its device work and host copies go to a side stream,
core/sinks.PassStream), so while the host merges pass k the card is already
computing pass k+1.

Over a mesh (``mesh=``, launch/mesh.make_mesh) one process drives every
rank, as the reference's single controller drives its shard_map: each rank
launches its own tiles of each pass on a CUDA stream of its device, and
the sink takes the pass as per-rank pieces, each with its own event
(:func:`_launches`).  A mesh result is bitwise the one-device run.

``execute_plan(recovery=RetryPolicy())`` arms the self-healing loop
(:func:`_execute_recovering`): transient failures retry in place, an
out-of-memory error halves the pass, a lost device goes to the policy's
resolver (by default a mesh drops a device and repartitions; one
device has no survivor), and every
attempt resumes from the tiles the sink already holds, so a recovered
result is bitwise a fault-free run.

Beside the executor: the raw pass stream (:func:`stream_tiles`), its host
assembly (:func:`assemble_from_stream`) and the reference's deprecated
drivers (``allpairs_pcc``, ``allpairs_pcc_streamed`` and their
``allpairs_similarity*`` aliases), each a thin wrapper over ``corr`` or
the stream.
"""

from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Callable, FrozenSet, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import measures
from repro_torch.core.mapping import job_coord_batch
from repro_torch.core.plan import ExecutionPlan, launch_operand
from repro_torch.core.quantize import Operand, operand_data, operand_parts
from repro_torch.core.sinks import (DenseSink, PassStream, TileSink, after,
                                    place_tiles_host)
from repro_torch.launch.mesh import Mesh
from repro_torch.kernels.pcc_tile import (DEFAULT_LBLK, DEFAULT_TILE,
                                          pcc_tiles, pcc_topk_tiles)
from repro_torch.runtime import faults


def launch_tiles(plan: ExecutionPlan, u, j0: int, launch: int,
                 v=None) -> torch.Tensor:
    """THE kernel-launch seam: one pass launch of the plan's tile kernel
    (v is the column operand of a rectangular plan, or a same-shape second
    operand on the triangle).  Unwraps quantized :class:`Operand`s and
    threads their per-row scales to the kernel: the row scales from u, the
    column scales from v, or from u when there is no v.  A measure with a
    custom ``tile_kernel`` (merge-sort Kendall) launches it instead, with
    the true sample count ``plan.l`` added to the shared signature."""
    u_data, u_scale = operand_parts(u)
    v_data, v_scale = operand_parts(v) if v is not None else (None, None)
    if plan.measure.tile_kernel is not None:
        return plan.measure.tile_kernel(
            u_data, j0, t=plan.t, l_blk=plan.l_blk, pass_tiles=launch,
            epilogue=plan.epilogue_spec, v_pad=v_data,
            grid_cols=plan.workload.grid_cols, l=plan.l)
    row_scale = col_scale = None
    if u_scale is not None:
        row_scale = u_scale
        col_scale = u_scale if v is None else v_scale
        if col_scale is None:
            raise ValueError("quantized row operand paired with an "
                             "unquantized column operand: both sides must "
                             "be prepared by the same plan")
    return pcc_tiles(u_data, j0, t=plan.t, l_blk=plan.l_blk,
                     pass_tiles=launch, epilogue=plan.epilogue_spec,
                     v_pad=v_data, grid_cols=plan.workload.grid_cols,
                     row_scale=row_scale, col_scale=col_scale)


def launch_topk_tiles(plan: ExecutionPlan, u, j0: int, dev_hi: int,
                      launch: int, kk: int, v=None):
    """Launch seam of the device-side top-k epilogue
    (kernels/pcc_tile.pcc_topk_tiles): one pass's tiles are computed and
    folded into per-row top-k state on the card, so only O(n * kk) state
    leaves it.  j0 is the raw pass start and dev_hi the exclusive tile
    bound, the kernel's validity guard.  Quantized operands and custom tile
    kernels are refused: neither the scale product nor another kernel is
    fused into the top-k kernel."""
    u_data, u_scale = operand_parts(u)
    v_data, _ = operand_parts(v) if v is not None else (None, None)
    if u_scale is not None or plan.measure.tile_kernel is not None:
        raise ValueError(
            "device top-k epilogue supports the plain GEMM kernel only "
            "(no quantized scales, no custom tile kernels): "
            "DeviceTopKSink.open validates this")
    return pcc_topk_tiles(u_data, j0, dev_hi, t=plan.t, l_blk=plan.l_blk,
                          pass_tiles=launch, kk=kk,
                          n_cols_valid=plan.n_cols,
                          symmetric_problem=plan.symmetric_problem,
                          epilogue=plan.epilogue_spec, v_pad=v_data,
                          grid_cols=plan.workload.grid_cols)


# One piece of a pass: (ids, tiles or top-k state, ready event or None).
# A pass is a list of pieces: the whole pass on one device, one piece per
# rank that has tiles in it on a mesh.
Piece = Tuple[np.ndarray, object, Optional["torch.cuda.Event"]]
PassItem = Tuple[int, List[Piece]]


def _ready_event(device: torch.device):
    """An event recorded now on the current stream of a CUDA device (the
    point after a pass's launch), or None on the CPU."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def _launch_pass(plan: ExecutionPlan, u_pad, v_pad, start: int, count: int,
                 dev_hi: int, state_k: Optional[int]) -> Piece:
    """Launch `count` tiles from id `start` on the current stream of the
    operands' device (top-k state with state_k, else tiles with the
    unfused epilogue applied) and record the piece's ready event."""
    if state_k is not None:
        buf = launch_topk_tiles(plan, u_pad, start, dev_hi, count, state_k,
                                v=v_pad)
    else:
        buf = launch_tiles(plan, u_pad, start, count, v=v_pad)
        if not plan.fused and plan.measure.epilogue is not None:
            buf = plan.measure.epilogue(buf, plan.l)
    ids = np.arange(start, start + count, dtype=np.int64)
    return ids, buf, _ready_event(operand_data(u_pad).device)


def _operand_on(op, dev: torch.device):
    """A prepared operand (tensor or :class:`Operand`) on `dev`: itself
    when it lies there, else a copy."""
    data, scale = operand_parts(op)
    if data.device == dev:
        return op
    data = data.to(dev)
    return data if scale is None else Operand(data, scale.to(dev))


class MeshRun:
    """Where a run's work lies: each operand (and its scales) copied once
    to each distinct device of the mesh, and a CUDA stream for each rank on
    its device (none on the CPU).  Without a mesh (or over one rank) the
    run is one rank on the operands' device, launching on its current
    stream: the one-device run is the mesh run at p = 1.

    With shard_u=True, U is row-sharded over the ranks (rows padded to a
    multiple of p), one shard on each rank's device, and
    :meth:`next_pass` gathers it onto each device, in flat rank order (the
    row order the reference's minor-axis-first all_gather assembles); the
    scales, (n_pad,) floats, are copied whole.  Rectangular runs copy V to
    every device, as the reference replicates it.
    """

    def __init__(self, plan: ExecutionPlan, mesh: Optional[Mesh], u_pad,
                 v_pad=None, shard_u: bool = False):
        if mesh is None:
            if plan.p != 1:
                raise ValueError(f"a plan over p={plan.p} ranks runs on a "
                                 f"mesh of {plan.p} ranks (mesh=...)")
            # shard_u without a mesh changes nothing, as in the reference
            shard_u = False
            ranks = (operand_data(u_pad).device,)
        elif mesh.size != plan.p:
            raise ValueError(f"plan.p={plan.p} does not match the mesh's "
                             f"{mesh.size} ranks")
        else:
            ranks = mesh.ranks
        if shard_u and v_pad is not None:
            raise ValueError("shard_u supports the symmetric workload only "
                             "(one operand to shard); rectangular runs "
                             "replicate both operands")
        self.plan = plan
        self.ranks = ranks
        self.devices = tuple(dict.fromkeys(ranks))
        self.shard_u = shard_u
        u_data, u_scale = operand_parts(u_pad)
        if shard_u:
            blk = -(-u_data.shape[0] // plan.p)
            u_data = F.pad(u_data, (0, 0, 0, blk * plan.p - u_data.shape[0]))
            self._shards = [u_data[r * blk:(r + 1) * blk].to(d)
                            for r, d in enumerate(self.ranks)]
            self._scales = {d: None if u_scale is None else u_scale.to(d)
                            for d in self.devices}
            self.u = {}
        else:
            self.u = {d: _operand_on(u_pad, d) for d in self.devices}
        self.v = {d: None if v_pad is None else _operand_on(v_pad, d)
                  for d in self.devices}
        self.streams = [torch.cuda.Stream(d)
                        if d.type == "cuda" and plan.p > 1 else None
                        for d in self.ranks]
        # per-operand state a custom kernel keeps (merge-sort Kendall's
        # rank structures), made on each device's current stream before
        # any rank stream reads it: ranks sharing a device share it (a run
        # without rank streams leaves it to the kernel's first launch)
        self._prepare = (getattr(plan.measure.tile_kernel,
                                 "prepare_operands", None)
                         if any(st is not None for st in self.streams)
                         else None)
        if not shard_u:
            self._prepare_state()

    def _prepare_state(self) -> None:
        if self._prepare is None:
            return
        for d in self.devices:
            v = self.v[d]
            self._prepare(operand_data(self.u[d]),
                          None if v is None else operand_data(v),
                          self.plan.l)

    def next_pass(self) -> None:
        """Before a pass's launches: under shard_u, gather U onto each
        device (on its current stream)."""
        if not self.shard_u:
            return
        for d in self.devices:
            data = torch.cat([s.to(d) for s in self._shards])
            data = data[:self.plan.n_pad]
            self.u[d] = (data if self._scales[d] is None
                         else Operand(data, self._scales[d]))
        self._prepare_state()

    def slots(self, k: int):
        """(rank, device, start, count) of each rank with tiles in pass k."""
        for r, (start, count) in enumerate(self.plan.rank_slots(k)):
            if count:
                yield r, self.ranks[r], start, count

    def dev_hi(self, r: int) -> int:
        """Exclusive tile bound of rank r (the top-k kernel's guard)."""
        return min((r + 1) * self.plan.per_dev, self.plan.total_tiles)

    @contextlib.contextmanager
    def on_rank(self, r: int, *bufs: torch.Tensor):
        """Run the block on rank r's stream, after everything queued on
        its device's current stream (the operands' copies, a pass's
        gather), keeping the operands and `bufs` (tensors on the rank's
        device) alive for it.  Yields the rank's (u, v) operands."""
        d, stream = self.ranks[r], self.streams[r]
        u, v = self.u[d], self.v[d]
        if stream is None:
            yield u, v
            return
        stream.wait_stream(torch.cuda.current_stream(d))
        for op in (u, v):
            if op is not None:
                for t in operand_parts(op):
                    if t is not None:
                        t.record_stream(stream)
        for buf in bufs:
            buf.record_stream(stream)
        with torch.cuda.stream(stream):
            yield u, v


def _launches(plan: ExecutionPlan, u_pad, mesh: Optional[Mesh],
              shard_u: bool, v_pad=None, start_pass: int = 0,
              skip: FrozenSet[int] = frozenset(),
              state_k: Optional[int] = None) -> Iterator[PassItem]:
    """Pass launches (paper SSIII-D), one process driving every rank
    (:class:`MeshRun`; one rank without a mesh): rank r owns the tile ids
    [r per_dev, (r + 1) per_dev) and launches, in pass k, the valid ones of
    its slots [r per_dev + off, ...) on its own stream, each kernel sized
    to its tile count.  A pass is handed on as per-rank pieces, each with
    its own ready event; no pass is gathered onto one device, so a device
    holds the pieces of its ranks only (two passes of them under the
    double buffer).  Ranks with no valid slot in a pass launch nothing:
    the reference's clamped duplicates exist only because shard_map is
    SPMD.  start_pass skips the passes a checkpoint already holds without
    computing them; `skip` drops individual later passes (a resume whose
    held passes are not a prefix, e.g. a corrupt region dropped).  state_k
    switches to the device top-k epilogue: a piece's buffer is the
    kernel's per-row state tuple instead of tiles.  Each launched pass
    first passes the ``pass_launch`` fault site, as the reference's do."""
    if state_k is not None and shard_u:
        raise ValueError(
            "device top-k state does not compose with shard_u: the in-shard "
            "all_gather would re-run per pass against state-shaped outputs")
    run = MeshRun(plan, mesh, u_pad, v_pad, shard_u)
    for k in range(plan.n_pass):
        if k < start_pass or k in skip:
            continue
        faults.check("pass_launch")
        run.next_pass()
        pieces = []
        for r, _d, start, count in run.slots(k):
            with run.on_rank(r) as (u, v):
                pieces.append(_launch_pass(plan, u, v, start, count,
                                           run.dev_hi(r), state_k))
        yield k, pieces


def _stream(plan: ExecutionPlan, u_pad, v_pad=None, start_pass: int = 0,
            skip: FrozenSet[int] = frozenset(),
            state_k: Optional[int] = None, mesh: Optional[Mesh] = None,
            shard_u: bool = False) -> Iterator[PassItem]:
    """Double-buffered pass stream of (k, pieces): launches pass k+1
    before yielding pass k, so the sink's work on pass k overlaps it.
    u_pad and v_pad are prepared operands (tensors or quantized
    :class:`Operand`s); on a triangular plan v_pad may be a second operand
    of u_pad's shape (the masked measures' cross components).  Without a
    mesh the plan must be a one-device plan (and shard_u is moot).
    start_pass, skip and state_k: see :func:`_launches`."""
    launches = _launches(plan, u_pad, mesh, shard_u, v_pad, start_pass,
                         skip, state_k)
    pending = None
    for item in launches:
        if pending is not None:
            yield pending
        pending = item
    if pending is not None:
        yield pending


MakeStream = Callable[[int, FrozenSet[int]], Iterator[PassItem]]


def _consume_pieces(snk, pieces: List[Piece]) -> None:
    """Hand a pass's pieces to the sink, in rank order.  A helper of its
    own so that no piece outlives the call in the caller's frame."""
    for ids, buf, ready in pieces:
        snk.consume(ids, buf, ready)


def run_sink(plan: ExecutionPlan, sink: Optional[TileSink],
             device: torch.device, make_stream: MakeStream) -> object:
    """The one sink-driving loop behind every entry point: open the sink
    (DenseSink by default), read its resume schedule, drain the pass
    stream that ``make_stream(start_pass, skip)`` builds into it, one
    piece at a time, committing each pass after its last piece, and return
    its result.

    A sink that persists progress (HostSink with a memmap path) reports
    the first pass to run in ``resume_pass()`` and the later passes it
    already holds in ``skip_passes()``, which are never launched, and
    commits each pass in ``pass_complete(k)`` once it has consumed it.
    Duck-typed sinks without these hooks run every pass."""
    snk = sink if sink is not None else DenseSink()
    snk.open(plan, device)
    k0 = getattr(snk, "resume_pass", lambda: 0)()
    skip = getattr(snk, "skip_passes", set)()
    pass_complete = getattr(snk, "pass_complete", lambda k: None)
    for k, pieces in make_stream(k0, frozenset(skip)):
        _consume_pieces(snk, pieces)
        pass_complete(k)
        # let go of pass k before pass k + 2 is launched: two pass buffers
        # live (the double buffer), not three
        del pieces
    return snk.result()


def _check_operands(plan: ExecutionPlan, u_pad, v_pad, dev: torch.device):
    """Refuse operands that do not fit the plan or do not lie on dev."""
    l_pad = plan.l_pad
    dtype = plan.compute_dtype or torch.float32
    operands = [("u_pad", u_pad, plan.n_pad)]
    if plan.workload.needs_symmetrize:
        if v_pad is not None:
            raise ValueError("a symmetric plan takes one operand; "
                             "create(..., n_cols=) for X-vs-Y")
    else:
        if v_pad is None:
            raise ValueError("a rectangular plan needs v_pad, the prepared "
                             "column operand")
        operands.append(("v_pad", v_pad, plan.col_pad))
    for name, op, rows in operands:
        if isinstance(op, Operand) != plan.scaled:
            raise ValueError(
                f"{name} must be {'an' if plan.scaled else 'no'} Operand of "
                f"quantized data and row scales for this plan")
        data, scale = operand_parts(op)
        if data.device.type != dev.type or dev.index not in (
                None, data.device.index):
            raise ValueError(f"{name} lies on {data.device}, not on {dev}")
        if tuple(data.shape) != (rows, l_pad):
            raise ValueError(f"{name} shape {tuple(data.shape)} does not "
                             f"match the plan's ({rows}, {l_pad})")
        if data.dtype != dtype:
            raise ValueError(f"{name} is {data.dtype}; the plan stores "
                             f"{dtype}")
        if scale is not None and tuple(scale.shape) != (rows,):
            raise ValueError(f"{name} scales {tuple(scale.shape)} do not "
                             f"match its {rows} rows")


def check_mesh(mesh, device=None) -> Optional[torch.device]:
    """The device a run over `mesh` keeps its operands and its sink on:
    the mesh's first device (None without a mesh).  A `mesh` that is not
    a :class:`Mesh` raises TypeError; a `device` that is not that first
    device (by type, and by index where it names one) raises
    ValueError."""
    if mesh is None:
        return None
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a repro_torch.launch.mesh.Mesh "
                        f"(make_mesh), got {type(mesh).__name__}")
    first = mesh.ranks[0]
    if device is not None:
        dev = torch.device(device)
        if dev.type != first.type or dev.index not in (None, first.index):
            raise ValueError(f"device={dev} disagrees with the mesh, whose "
                             f"first device {first} holds the operands and "
                             f"the result")
    return first


def execute_plan(plan: ExecutionPlan, u_pad, v_pad=None, *,
                 sink: Optional[TileSink] = None, device=None,
                 mesh: Optional[Mesh] = None, shard_u: bool = False,
                 recovery: Optional[faults.RetryPolicy] = None):
    """Run a prepared plan end to end on the device that holds ``u_pad``
    (and ``v_pad``, the column operand a rectangular plan needs), or over
    `mesh` (launch/mesh.make_mesh), whose size must be ``plan.p`` and
    whose first device holds the operands and the sink's device state.
    Operands are tensors, or :class:`Operand`s of data and per-row scales
    when the plan quantizes (``plan.scaled``).

    ``device`` (None means "cuda", or the mesh's first device) must match
    the operands' device; it is explicit so a CPU run is always asked for.
    shard_u=True row-shards U over the mesh (:func:`_launches`).
    ``recovery=RetryPolicy()`` arms the self-healing loop
    (:func:`_execute_recovering`): transient failures retry in place,
    out-of-memory errors halve the pass, device loss goes to the policy's
    resolver (by default: drop a device of the mesh and repartition), and
    the run resumes from the tiles the sink already holds, bitwise an
    uninterrupted run.
    """
    first = check_mesh(mesh, device)
    dev = first if first is not None else resolve_device(device)
    _check_operands(plan, u_pad, v_pad, dev)
    state_k = _sink_state_k(sink)
    # int16 operands (exact +/-1/0 signs) run the int8 kernels
    u_pad = launch_operand(u_pad)
    v_pad = None if v_pad is None else launch_operand(v_pad)
    if recovery is not None:
        return _execute_recovering(plan, u_pad, v_pad, sink=sink,
                                   device=operand_data(u_pad).device,
                                   mesh=mesh, shard_u=shard_u,
                                   policy=recovery)
    return run_sink(plan, sink, operand_data(u_pad).device,
                    lambda k0, skip: _stream(plan, u_pad, v_pad, k0, skip,
                                             state_k, mesh, shard_u))


def _sink_state_k(sink: Optional[TileSink]) -> Optional[int]:
    """State capacity for sinks that want the device top-k stream
    (core/sinks.DeviceTopKSink), else None (the tile stream)."""
    if sink is not None and getattr(sink, "wants_device_state", False):
        return int(sink.k)
    return None


def _default_shrink(mesh: Optional[Mesh], plan: ExecutionPlan,
                    exc: BaseException):
    """Default device-loss resolution, the reference's: drop one device,
    flatten the survivors into a 1-D mesh (None when one survives: local
    launches on the mesh's first device) and repartition the plan
    (runtime/elastic.py).  A run on one device has no survivor: the loss
    propagates."""
    from repro_torch.runtime import elastic  # elastic imports core.plan

    if mesh is None:
        raise exc
    new_mesh = elastic.shrink_mesh(mesh)
    new_p = 1 if new_mesh is None else new_mesh.size
    return new_mesh, elastic.replan_execution(plan, new_p)


def _consume_fresh(snk, pieces: List[Piece], covered: np.ndarray,
                   merge_dedups: bool) -> None:
    """Hand the sink the tiles of a pass's pieces that `covered` lacks and
    mark each piece's tiles covered once it is consumed: a failure at a
    later piece reruns the pass, and only the pieces not handed over are
    fresh then."""
    for ids, buf, ready in pieces:
        fresh = ~covered[ids]
        if merge_dedups:
            # a state tuple cannot be cut by tile id; the sink's canonical
            # merge drops the exact duplicates a rerun pass re-delivers
            if fresh.any():
                snk.consume(ids, buf, ready)
        elif fresh.all():
            snk.consume(ids, buf, ready)
        elif fresh.any():
            # cut on the piece's device, after its launch
            after(ready, buf)
            sel = torch.as_tensor(np.nonzero(fresh)[0], device=buf.device)
            snk.consume(ids[fresh], buf[sel], None)
        covered[ids] = True


def _consume_attempt(snk, stream, covered: np.ndarray, merge_dedups: bool,
                     pass_complete, landed: list) -> None:
    """Drain one attempt's pass stream into the sink (:func:`_consume_fresh`),
    commit each pass after its last piece and count it in ``landed[0]``.
    A helper of its own so that its pass buffers die with its frame when
    an attempt fails."""
    for k, pieces in stream:
        _consume_fresh(snk, pieces, covered, merge_dedups)
        pass_complete(k)
        landed[0] += 1
        del pieces   # two pass buffers live, as in run_sink


def _execute_recovering(plan: ExecutionPlan, u_pad, v_pad, *,
                        sink: Optional[TileSink], device: torch.device,
                        mesh: Optional[Mesh], shard_u: bool,
                        policy: faults.RetryPolicy):
    """The self-healing executor loop, the reference's.

    Progress is a host-side coverage bitmap over tile ids (not pass
    indices), seeded from the sink's own coverage (``covered()``).  Each
    attempt derives its pass schedule from it (``plan.coverage_schedule``),
    streams the remaining passes and hands the sink only the tiles it
    lacks, so sinks whose merge is not idempotent (TopKSink candidates,
    EdgeCountSink counts) stay exact when a rerun pass overlaps tiles that
    already landed.  A mesh pass's pieces are marked covered one by one,
    so a failure inside a pass reruns only the pieces it had not handed
    over.

    Failures, by ``faults.classify_failure``:
      transient    retry in place after the policy's backoff; the retry
                   budget refills whenever a pass lands
      oom          halve max_tiles_per_pass (never below 1), rebind the
                   sink, retry
      device_loss  ``policy.on_device_loss(mesh, plan, exc)`` -> (mesh,
                   plan); by default (:func:`_default_shrink`) drop a
                   device of the mesh and repartition onto the survivors,
                   fatal on one device; rebind, continue
      crash/fatal  propagate: a simulated process death is recovered by a
                   restart with ``resume_from=``, never in-process; a
                   kernel that fails to build or launch is never retried
                   on a plain version.

    On the card: the pass stream is closed before the next attempt, so the
    pass it launched but had not yielded is freed before a smaller pass is
    tried; the side-stream work of passes already consumed stays queued.
    """
    snk = sink if sink is not None else DenseSink()
    snk.open(plan, device)
    covered = getattr(snk, "covered", lambda: None)()
    if covered is None or np.shape(covered) != (plan.total_tiles,):
        covered = np.zeros(plan.total_tiles, bool)
    else:
        covered = np.asarray(covered, bool).copy()
    pass_complete = getattr(snk, "pass_complete", lambda k: None)
    state_k = _sink_state_k(snk)
    merge_dedups = getattr(snk, "merge_dedups", False)
    failures = 0
    while not covered.all():
        k0, skip = plan.coverage_schedule(covered)
        if k0 >= plan.n_pass:
            break
        stream = _stream(plan, u_pad, v_pad, k0, frozenset(skip), state_k,
                         mesh, shard_u)
        landed = [0]
        try:
            _consume_attempt(snk, stream, covered, merge_dedups,
                             pass_complete, landed)
        except BaseException as exc:
            stream.close()
            if landed[0]:
                failures = 0  # forward progress refills the retry budget
            kind = faults.classify_failure(exc)
            if kind == "transient":
                failures += 1
                if failures > policy.max_retries:
                    policy.log.append({"kind": kind, "action": "give_up",
                                       "attempt": failures})
                    raise
                policy.log.append({"kind": kind, "action": "retry",
                                   "attempt": failures, "error": str(exc)})
                policy.sleep(policy.backoff(failures - 1))
                continue
            if kind == "oom" and policy.shrink_pass_on_oom:
                if plan.max_tiles_per_pass <= 1:
                    policy.log.append({"kind": kind, "action": "give_up",
                                       "max_tiles_per_pass": 1})
                    raise
                plan = dataclasses.replace(
                    plan,
                    max_tiles_per_pass=max(1, plan.max_tiles_per_pass // 2))
                policy.log.append(
                    {"kind": kind, "action": "shrink_pass",
                     "max_tiles_per_pass": plan.max_tiles_per_pass})
                getattr(snk, "rebind", lambda _p: None)(plan)
                continue
            if kind == "device_loss" and policy.shrink_on_device_loss:
                resolver = policy.on_device_loss or _default_shrink
                mesh, plan = resolver(mesh, plan, exc)
                if mesh is not None and mesh.size != plan.p:
                    raise ValueError(
                        f"on_device_loss returned a mesh of {mesh.size} "
                        f"ranks and a plan over p={plan.p}") from exc
                if mesh is None:
                    if plan.p != 1:
                        raise ValueError(
                            f"on_device_loss returned no mesh and a plan "
                            f"over p={plan.p}") from exc
                    shard_u = False
                policy.log.append({"kind": kind, "action": "shrink_mesh",
                                   "p": plan.p, "error": str(exc)})
                getattr(snk, "rebind", lambda _p: None)(plan)
                continue
            policy.log.append({"kind": kind, "action": "raise",
                               "error": str(exc)})
            raise
    return snk.result()


def resolve_device(device) -> torch.device:
    """None means "cuda".  A CUDA device on a machine without one raises:
    no entry point falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on an NVIDIA GPU "
            "and takes the CPU only when asked (device='cpu')")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def allpairs(x, *, measure: measures.MeasureLike = "pearson",
             sink: Optional[TileSink] = None, mesh: Optional[Mesh] = None,
             shard_u: bool = False, t: int = DEFAULT_TILE,
             l_blk: int = DEFAULT_LBLK,
             max_tiles_per_pass: Optional[int] = None, clip: bool = True,
             fuse_epilogue: bool = True, compute_dtype=None, device=None):
    """Symmetric all-pairs similarity: the spelling of ``corr(x, ...)``
    kept from the reference."""
    from repro_torch.core.api import corr  # api builds on this module
    return corr(x, measure=measure, sink=sink, mesh=mesh, shard_u=shard_u,
                t=t, l_blk=l_blk, max_tiles_per_pass=max_tiles_per_pass,
                clip=clip, fuse_epilogue=fuse_epilogue,
                compute_dtype=compute_dtype, device=device)


def stream_tiles(x, *, t: int = DEFAULT_TILE, l_blk: int = DEFAULT_LBLK,
                 measure: measures.MeasureLike = "pearson", mesh=None,
                 shard_u: bool = False,
                 max_tiles_per_pass: Optional[int] = None, clip: bool = True,
                 fuse_epilogue: bool = True, compute_dtype=None,
                 plan: Optional[ExecutionPlan] = None,
                 device=None) -> Iterator[Tuple[np.ndarray, torch.Tensor]]:
    """Yield (tile_ids, tiles) per pass as (host ids, device buffer): the
    raw executor stream of a symmetric run, double-buffered (pass k + 1 is
    launched before pass k is yielded).  Tiles carry the measure's epilogue
    (fused in the kernel by default); ids are unique, valid and in pass
    order.  x is a numpy array or tensor, moved to ``device`` (None means
    "cuda", or the mesh's first device).  Over a mesh each rank's piece of
    a pass comes as its own (ids, tiles), on its rank's device; shard_u
    row-shards U over it.  Pass ``plan=`` to reuse a built ExecutionPlan:
    its geometry and p must match x and the mesh, and per-call keywords
    that conflict with it are refused (default-valued ones cannot be told
    from unset, so only non-default conflicts are seen)."""
    for _k, ids, buf, _ready in _symmetric_stream(
            x, t=t, l_blk=l_blk, measure=measure, mesh=mesh, shard_u=shard_u,
            max_tiles_per_pass=max_tiles_per_pass, clip=clip,
            fuse_epilogue=fuse_epilogue, compute_dtype=compute_dtype,
            plan=plan, device=device):
        yield ids, buf


def _symmetric_stream(x, *, t, l_blk, measure, mesh, shard_u,
                      max_tiles_per_pass, clip, fuse_epilogue, compute_dtype,
                      plan, device) -> Iterator[PassItem]:
    """:func:`stream_tiles`' pieces as (k, ids, tiles, ready), one a rank
    that has tiles in pass k."""
    first = check_mesh(mesh, device)
    dev = first if first is not None else resolve_device(device)
    p = 1 if mesh is None else mesh.size
    x = torch.as_tensor(x, device=dev)
    if plan is None:
        plan = ExecutionPlan.create(
            x.shape[0], x.shape[1], t=t, l_blk=l_blk, measure=measure, p=p,
            max_tiles_per_pass=max_tiles_per_pass, clip=clip,
            fuse_epilogue=fuse_epilogue, compute_dtype=compute_dtype)
    else:
        if plan.p != p:
            raise ValueError(f"plan.p={plan.p} does not match mesh size {p}")
        if t != DEFAULT_TILE and t != plan.t:
            raise ValueError(f"t={t} conflicts with plan.t={plan.t}")
        if l_blk != DEFAULT_LBLK and l_blk != plan.l_blk:
            raise ValueError(
                f"l_blk={l_blk} conflicts with plan.l_blk={plan.l_blk}")
        req = measures.get(measure)
        resolved = measures.resolve_tile_kernel(
            req, l=plan.l, compute_dtype=plan.compute_dtype,
            replicas=plan.replicas)
        if (measure != "pearson" and req is not plan.measure
                and resolved is not plan.measure):
            raise ValueError(
                f"measure={req.name!r} conflicts with "
                f"plan.measure={plan.measure.name!r}")
    if not plan.workload.needs_symmetrize:
        raise ValueError("stream_tiles streams a symmetric plan; a "
                         "rectangular one runs through corr(x, y, sink=...)")
    for k, pieces in _stream(plan, launch_operand(plan.prepare(x)),
                             mesh=mesh, shard_u=shard_u):
        for ids, buf, ready in pieces:
            yield k, ids, buf, ready


def assemble_from_stream(n: int, t: int, m: int,
                         stream: Iterator[Tuple[np.ndarray, object]],
                         out: Optional[np.ndarray] = None,
                         measure: measures.MeasureLike = "pearson",
                         ) -> np.ndarray:
    """Assemble a streamed tile sequence of a symmetric run into the full
    (n, n) host matrix.

    The tiles already carry the measure's epilogue; assembly mirrors
    (``place_tiles_host``, rows written as slices of tile runs) and, for
    bounded measures, clips.  Tiles may be host arrays or tensors (copied
    to the host).  ``out`` is an optional (m t, m t) float32 array to
    assemble into.  (The sink spelling is ``corr(x, sink=HostSink())``,
    which fuses streaming and assembly.)

    CAUTION: ``measure`` must match the one the stream was produced with:
    the stream is just arrays and cannot be checked.  The default assumes
    Pearson; assembling another measure's stream without repeating
    ``measure=`` applies Pearson's [-1, 1] clip, truncating unbounded
    measures such as covariance.
    """
    meas = measures.get(measure)
    n_pad = m * t
    r = out if out is not None else np.zeros((n_pad, n_pad), np.float32)
    for ids, tiles in stream:
        ys, xs = job_coord_batch(m, np.asarray(ids))
        if isinstance(tiles, torch.Tensor):
            tiles = tiles.cpu().numpy()
        place_tiles_host(r, np.asarray(tiles), ys, xs, t)
    r = r[:n, :n]
    if meas.clip is not None:
        np.clip(r, meas.clip[0], meas.clip[1], out=r)
    return r


def warn_deprecated_driver(name: str, replacement: str) -> None:
    """One DeprecationWarning per legacy-driver call, naming corr().

    stacklevel=3 points at the user's call site (user -> wrapper -> here);
    the wrapped corr() / stream_tiles() never warn again, so each call
    warns exactly once."""
    warnings.warn(
        f"{name} is deprecated; use repro_torch.core.api.corr("
        f"{replacement}) — outputs are bit-identical through the unified "
        f"executor", DeprecationWarning, stacklevel=3)


def allpairs_pcc(x, *, t: int = DEFAULT_TILE, l_blk: int = DEFAULT_LBLK,
                 max_tiles_per_pass: Optional[int] = None, clip: bool = True,
                 measure: measures.MeasureLike = "pearson",
                 fuse_epilogue: bool = True, compute_dtype=None,
                 device=None) -> torch.Tensor:
    """All-pairs similarity through the triangular tile kernel: the (n, n)
    matrix on the device.  Deprecated spelling of ``corr(x, ...)``,
    bit-identical."""
    warn_deprecated_driver("allpairs_pcc", "x, measure=...")
    return allpairs(x, measure=measure, t=t, l_blk=l_blk,
                    max_tiles_per_pass=max_tiles_per_pass, clip=clip,
                    fuse_epilogue=fuse_epilogue, compute_dtype=compute_dtype,
                    device=device)


def allpairs_pcc_streamed(x, *, t: int = DEFAULT_TILE,
                          l_blk: int = DEFAULT_LBLK,
                          max_tiles_per_pass: int = 1024,
                          measure: measures.MeasureLike = "pearson",
                          fuse_epilogue: bool = True, compute_dtype=None,
                          device=None
                          ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Memory-bounded streaming (paper Alg. 2, double buffered): yields
    (tile_ids, tiles) per pass as host numpy arrays while the next pass is
    already launched.  Deprecated spelling of ``stream_tiles(x, ...)`` with
    a host copy; new code passes a TileSink to ``corr``."""
    warn_deprecated_driver("allpairs_pcc_streamed", "x, sink=HostSink(...)")
    side = None
    for _k, ids, buf, ready in _symmetric_stream(
            x, t=t, l_blk=l_blk, measure=measure, mesh=None, shard_u=False,
            max_tiles_per_pass=max_tiles_per_pass, clip=True,
            fuse_epilogue=fuse_epilogue, compute_dtype=compute_dtype,
            plan=None, device=device):
        # the copy waits on this pass alone; the next is already launched
        side = side or PassStream(buf.device)
        with side.pass_of(ready, buf):
            host, = side.to_host(buf)
        yield ids, host


# Measure-agnostic aliases: the `_pcc` names are kept from the reference,
# but the drivers serve every registered measure.
allpairs_similarity = allpairs_pcc
allpairs_similarity_streamed = allpairs_pcc_streamed


__all__ = ["launch_tiles", "launch_topk_tiles", "run_sink", "execute_plan",
           "allpairs", "resolve_device", "stream_tiles",
           "assemble_from_stream", "warn_deprecated_driver", "allpairs_pcc",
           "allpairs_pcc_streamed", "allpairs_similarity",
           "allpairs_similarity_streamed"]
