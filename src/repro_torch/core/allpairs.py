"""The plan-driven all-pairs executor (one device, symmetric or X-vs-Y).

Port of the single-device path of ``repro/core/allpairs.py``:

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

``execute_plan(recovery=RetryPolicy())`` arms the self-healing loop
(:func:`_execute_recovering`): transient failures retry in place, an
out-of-memory error halves the pass, a lost device goes to the policy's
resolver (one device has no survivor: fatal by default), and every
attempt resumes from the tiles the sink already holds, so a recovered
result is bitwise a fault-free run.

Beside the executor: the raw pass stream (:func:`stream_tiles`), its host
assembly (:func:`assemble_from_stream`) and the reference's deprecated
drivers (``allpairs_pcc``, ``allpairs_pcc_streamed`` and their
``allpairs_similarity*`` aliases), each a thin wrapper over ``corr`` or
the stream.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, FrozenSet, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import measures
from repro_torch.core.mapping import job_coord_batch
from repro_torch.core.plan import ExecutionPlan, launch_operand
from repro_torch.core.quantize import Operand, operand_data, operand_parts
from repro_torch.core.sinks import (DenseSink, PassStream, TileSink,
                                    place_tiles_host)
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


PassItem = Tuple[int, np.ndarray, object, Optional["torch.cuda.Event"]]


def _ready_event(device: torch.device):
    """An event recorded now on the current stream of a CUDA device (the
    point after a pass's launch), or None on the CPU."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def _local_launches(plan: ExecutionPlan, u_pad, v_pad=None,
                    start_pass: int = 0, skip: FrozenSet[int] = frozenset(),
                    state_k: Optional[int] = None) -> Iterator[PassItem]:
    """Single-device pass launches: consecutive spans of the tile-id range,
    each kernel sized to its actual tile count (every slot is valid).
    start_pass skips the passes a checkpoint already holds without
    computing them; `skip` drops individual later passes (a resume whose
    held passes are not a prefix, e.g. a corrupt region dropped).  state_k
    switches to the device top-k epilogue: the buffer becomes the kernel's
    per-row state tuple instead of tiles.  Each item carries the event
    recorded after its launch (None on the CPU).  Each launched pass
    first passes the ``pass_launch`` fault site, as the reference's do."""
    device = operand_data(u_pad).device
    for k, launch in enumerate(plan.launch_sizes):
        if k < start_pass or k in skip:
            continue
        faults.check("pass_launch")
        lo = plan.pass_offset(k)
        ids = plan.pass_ids(k)
        if state_k is not None:
            buf = launch_topk_tiles(plan, u_pad, lo, plan.total_tiles,
                                    launch, state_k, v=v_pad)
        else:
            buf = launch_tiles(plan, u_pad, lo, launch, v=v_pad)
            if not plan.fused and plan.measure.epilogue is not None:
                buf = plan.measure.epilogue(buf, plan.l)
        yield k, ids, buf, _ready_event(device)


def _stream(plan: ExecutionPlan, u_pad, v_pad=None, start_pass: int = 0,
            skip: FrozenSet[int] = frozenset(),
            state_k: Optional[int] = None) -> Iterator[PassItem]:
    """Double-buffered pass stream of (k, ids, tiles or state, ready):
    launches pass k+1 before yielding pass k, so the sink's work on pass k
    overlaps it.  u_pad and v_pad are prepared operands (tensors or
    quantized :class:`Operand`s); on a triangular plan v_pad may be a
    second operand of u_pad's shape (the masked measures' cross
    components).  start_pass and skip: see :func:`_local_launches`."""
    pending = None
    for item in _local_launches(plan, u_pad, v_pad, start_pass, skip,
                                state_k):
        if pending is not None:
            yield pending
        pending = item
    if pending is not None:
        yield pending


MakeStream = Callable[[int, FrozenSet[int]], Iterator[PassItem]]


def run_sink(plan: ExecutionPlan, sink: Optional[TileSink],
             device: torch.device, make_stream: MakeStream) -> object:
    """The one sink-driving loop behind every entry point: open the sink
    (DenseSink by default), read its resume schedule, drain the pass
    stream that ``make_stream(start_pass, skip)`` builds into it,
    committing each pass, and return its result.

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
    for k, ids, buf, ready in make_stream(k0, frozenset(skip)):
        snk.consume(ids, buf, ready)
        pass_complete(k)
        # let go of pass k before pass k + 2 is launched: two pass buffers
        # live (the double buffer), not three
        del buf
    return snk.result()


def execute_plan(plan: ExecutionPlan, u_pad, v_pad=None, *,
                 sink: Optional[TileSink] = None, device=None,
                 recovery: Optional[faults.RetryPolicy] = None):
    """Run a prepared plan end to end on the device that holds ``u_pad``
    (and ``v_pad``, the column operand a rectangular plan needs).  Operands
    are tensors, or :class:`Operand`s of data and per-row scales when the
    plan quantizes (``plan.scaled``).

    ``device`` (None means "cuda") must match the operands' device; it is
    explicit so a CPU run is always asked for.  ``recovery=RetryPolicy()``
    arms the self-healing loop (:func:`_execute_recovering`): transient
    failures retry in place, out-of-memory errors halve the pass, device
    loss goes to the policy's resolver, and the run resumes from the tiles
    the sink already holds, bitwise an uninterrupted run.
    """
    dev = resolve_device(device)
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
    state_k = _sink_state_k(sink)
    # int16 operands (exact +/-1/0 signs) run the int8 kernels
    u_pad = launch_operand(u_pad)
    v_pad = None if v_pad is None else launch_operand(v_pad)
    if recovery is not None:
        return _execute_recovering(plan, u_pad, v_pad, sink=sink,
                                   device=operand_data(u_pad).device,
                                   policy=recovery)
    return run_sink(plan, sink, operand_data(u_pad).device,
                    lambda k0, skip: _stream(plan, u_pad, v_pad, k0, skip,
                                             state_k))


def _sink_state_k(sink: Optional[TileSink]) -> Optional[int]:
    """State capacity for sinks that want the device top-k stream
    (core/sinks.DeviceTopKSink), else None (the tile stream)."""
    if sink is not None and getattr(sink, "wants_device_state", False):
        return int(sink.k)
    return None


def _default_shrink(mesh, plan: ExecutionPlan, exc: BaseException):
    """Default device-loss resolution.  The reference drops the lost device
    and repartitions onto the survivors; a run on one device (``mesh``
    None, the only kind this package has until ROADMAP A6) has none, so
    the loss propagates, as the reference's local run does."""
    del mesh, plan
    raise exc


def _consume_attempt(snk, stream, covered: np.ndarray, merge_dedups: bool,
                     pass_complete, landed: list) -> None:
    """Drain one attempt's pass stream into the sink, handing it only the
    tiles `covered` lacks, mark each landed pass covered and count it in
    ``landed[0]``.  A helper of its own so that its pass buffers die with
    its frame when an attempt fails."""
    for k, ids, buf, ready in stream:
        fresh = ~covered[ids]
        if merge_dedups:
            # a state tuple cannot be cut by tile id; the sink's canonical
            # merge drops the exact duplicates a rerun pass re-delivers
            if fresh.any():
                snk.consume(ids, buf, ready)
        elif fresh.all():
            snk.consume(ids, buf, ready)
        elif fresh.any():
            # cut on the device, queued on the current stream after the
            # launches so far: the sink waits on everything queued
            sel = torch.as_tensor(np.nonzero(fresh)[0], device=buf.device)
            snk.consume(ids[fresh], buf[sel], None)
        covered[ids] = True
        pass_complete(k)
        landed[0] += 1
        del buf   # two pass buffers live, as in run_sink


def _execute_recovering(plan: ExecutionPlan, u_pad, v_pad, *,
                        sink: Optional[TileSink], device: torch.device,
                        policy: faults.RetryPolicy):
    """The self-healing executor loop, the reference's.

    Progress is a host-side coverage bitmap over tile ids (not pass
    indices), seeded from the sink's own coverage (``covered()``).  Each
    attempt derives its pass schedule from it (``plan.coverage_schedule``),
    streams the remaining passes and hands the sink only the tiles it
    lacks, so sinks whose merge is not idempotent (TopKSink candidates,
    EdgeCountSink counts) stay exact when a rerun pass overlaps tiles that
    already landed.

    Failures, by ``faults.classify_failure``:
      transient    retry in place after the policy's backoff; the retry
                   budget refills whenever a pass lands
      oom          halve max_tiles_per_pass (never below 1), rebind the
                   sink, retry
      device_loss  ``policy.on_device_loss`` (default: fatal on one device,
                   :func:`_default_shrink`), rebind, continue
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
        stream = _stream(plan, u_pad, v_pad, k0, frozenset(skip), state_k)
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
                mesh, plan = resolver(None, plan, exc)
                if mesh is not None:
                    raise NotImplementedError(
                        "on_device_loss returned a mesh: running on one is "
                        "not ported yet: ROADMAP slice 11 (multi-GPU)")
                policy.log.append({"kind": kind, "action": "shrink_mesh",
                                   "p": 1, "error": str(exc)})
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
             sink: Optional[TileSink] = None, t: int = DEFAULT_TILE,
             l_blk: int = DEFAULT_LBLK,
             max_tiles_per_pass: Optional[int] = None, clip: bool = True,
             fuse_epilogue: bool = True, compute_dtype=None, device=None):
    """Symmetric all-pairs similarity: the spelling of ``corr(x, ...)``
    kept from the reference."""
    from repro_torch.core.api import corr  # api builds on this module
    return corr(x, measure=measure, sink=sink, t=t, l_blk=l_blk,
                max_tiles_per_pass=max_tiles_per_pass, clip=clip,
                fuse_epilogue=fuse_epilogue, compute_dtype=compute_dtype,
                device=device)


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
    "cuda").  Pass ``plan=`` to reuse a built ExecutionPlan: its geometry
    must match x, and per-call keywords that conflict with it are refused
    (default-valued ones cannot be told from unset, so only non-default
    conflicts are seen).  ``mesh`` / ``shard_u`` are the reference's and
    raise NotImplementedError (ROADMAP slice 11 (multi-GPU))."""
    for _k, ids, buf, _ready in _symmetric_stream(
            x, t=t, l_blk=l_blk, measure=measure, mesh=mesh, shard_u=shard_u,
            max_tiles_per_pass=max_tiles_per_pass, clip=clip,
            fuse_epilogue=fuse_epilogue, compute_dtype=compute_dtype,
            plan=plan, device=device):
        yield ids, buf


def _symmetric_stream(x, *, t, l_blk, measure, mesh, shard_u,
                      max_tiles_per_pass, clip, fuse_epilogue, compute_dtype,
                      plan, device) -> Iterator[PassItem]:
    """:func:`stream_tiles`' pass items, each with its ready event."""
    if mesh is not None or shard_u:
        raise NotImplementedError(
            f"stream_tiles({'mesh' if mesh is not None else 'shard_u'}=...)"
            f" is not ported yet: ROADMAP slice 11 (multi-GPU)")
    dev = resolve_device(device)
    x = torch.as_tensor(x, device=dev)
    if plan is None:
        plan = ExecutionPlan.create(
            x.shape[0], x.shape[1], t=t, l_blk=l_blk, measure=measure,
            max_tiles_per_pass=max_tiles_per_pass, clip=clip,
            fuse_epilogue=fuse_epilogue, compute_dtype=compute_dtype)
    else:
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
    yield from _stream(plan, plan.prepare(x))


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
