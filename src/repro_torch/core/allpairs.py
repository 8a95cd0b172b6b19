"""The plan-driven all-pairs executor (one device).

Port of the single-device path of ``repro/core/allpairs.py``:

    ExecutionPlan (core/plan.py)   what to run, decided once on the host
        |
    executor (this module)         iterate passes with double buffering:
        |                          pass k+1 is launched before the sink
        v                          touches pass k (paper Alg. 2)
    TileSink (core/sinks.py)       what becomes of the tiles

Kernel launches are asynchronous on the current CUDA stream, so while the
host inverts pass k's tile ids and queues its scatter, the card is already
computing pass k+1; the scatter runs on the same stream after it.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import measures
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.sinks import DenseSink, TileSink
from repro_torch.kernels.pcc_tile import DEFAULT_LBLK, DEFAULT_TILE, pcc_tiles


def launch_tiles(plan: ExecutionPlan, u_pad: torch.Tensor, j0: int,
                 launch: int) -> torch.Tensor:
    """THE kernel-launch seam: one pass launch of the plan's tile kernel."""
    return pcc_tiles(u_pad, j0, t=plan.t, l_blk=plan.l_blk,
                     pass_tiles=launch, epilogue=plan.epilogue_spec)


def _local_launches(plan: ExecutionPlan, u_pad: torch.Tensor
                    ) -> Iterator[Tuple[int, np.ndarray, torch.Tensor]]:
    """Single-device pass launches: consecutive spans of the tile-id range,
    each kernel sized to its actual tile count (every slot is valid)."""
    for k, launch in enumerate(plan.launch_sizes):
        lo = plan.pass_offset(k)
        buf = launch_tiles(plan, u_pad, lo, launch)
        if not plan.fused and plan.measure.epilogue is not None:
            buf = plan.measure.epilogue(buf, plan.l)
        yield k, np.arange(lo, lo + launch, dtype=np.int64), buf


def _stream(plan: ExecutionPlan, u_pad: torch.Tensor
            ) -> Iterator[Tuple[int, np.ndarray, torch.Tensor]]:
    """Double-buffered pass stream of (k, ids, tiles): launches pass k+1
    before yielding pass k, so the sink's work on pass k overlaps it."""
    pending = None
    for item in _local_launches(plan, u_pad):
        if pending is not None:
            yield pending
        pending = item
    if pending is not None:
        yield pending


def run_sink(plan: ExecutionPlan, sink: Optional[TileSink],
             device: torch.device, stream) -> object:
    """Open the sink (DenseSink by default), drain the pass stream into
    it, and return its result."""
    snk = sink if sink is not None else DenseSink()
    snk.open(plan, device)
    for _k, ids, buf in stream:
        snk.consume(ids, buf)
    return snk.result()


def execute_plan(plan: ExecutionPlan, u_pad: torch.Tensor, *,
                 sink: Optional[TileSink] = None, device=None):
    """Run a prepared plan end to end on the device that holds ``u_pad``.

    ``device`` (None means "cuda") must match ``u_pad``'s device; it is
    explicit so a CPU run is always asked for.
    """
    dev = resolve_device(device)
    if u_pad.device.type != dev.type or dev.index not in (
            None, u_pad.device.index):
        raise ValueError(f"u_pad lies on {u_pad.device}, not on {dev}")
    l_pad = -(-plan.l // plan.l_blk) * plan.l_blk
    if tuple(u_pad.shape) != (plan.n_pad, l_pad):
        raise ValueError(f"u_pad shape {tuple(u_pad.shape)} does not match "
                         f"the plan's ({plan.n_pad}, {l_pad})")
    return run_sink(plan, sink, u_pad.device, _stream(plan, u_pad))


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
             fuse_epilogue: bool = True, device=None):
    """Symmetric all-pairs similarity: the spelling of ``corr(x, ...)``
    kept from the reference."""
    from repro_torch.core.api import corr  # api builds on this module
    return corr(x, measure=measure, sink=sink, t=t, l_blk=l_blk,
                max_tiles_per_pass=max_tiles_per_pass, clip=clip,
                fuse_epilogue=fuse_epilogue, device=device)


__all__ = ["launch_tiles", "run_sink", "execute_plan", "allpairs",
           "resolve_device"]
