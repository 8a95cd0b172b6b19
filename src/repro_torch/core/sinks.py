"""Tile sinks: what becomes of the executor's per-pass tile stream.

Port of ``TileSink`` / ``DenseSink`` of ``repro/core/sinks.py``.  Contract:
``open(plan, device)`` once, ``consume(ids, tiles)`` per pass with the
pass's unique global tile ids while the next pass is already launched
(double buffering), ``result()`` to close the run.  Tiles arrive with the
measure's epilogue applied; bounded measures are clipped in the kernel
(fused) or by the sink (unfused) — clipping is idempotent, so both agree
bit for bit.

Unlike the reference's functional scatter and ``where``-mirror, DenseSink
scatters and mirrors in place on its padded device matrix: no second and
third (n_pad, n_pad) buffer, which keeps n = 64K inside 80 GB.
"""

from __future__ import annotations

import abc

import numpy as np
import torch

from repro_torch.core.plan import ExecutionPlan

# Rows per band of the in-place mirror: bounds the temporary of a diagonal
# block at _BAND^2 floats.
_BAND = 2048


class TileSink(abc.ABC):
    """Consumes the executor's per-pass tile stream."""

    plan: ExecutionPlan

    def open(self, plan: ExecutionPlan, device: torch.device) -> None:
        """Called once before the first pass; allocate state here."""
        self.plan = plan

    @abc.abstractmethod
    def consume(self, ids: np.ndarray, tiles: torch.Tensor) -> None:
        """One pass's tiles: ids (P,) unique global tile ids, tiles
        (P, t, t) (epilogue applied; clipped iff fused)."""

    @abc.abstractmethod
    def result(self):
        """Finalise and return the run's output."""


def scatter_tiles_at(r_pad: torch.Tensor, tiles: torch.Tensor,
                     ys: np.ndarray, xs: np.ndarray, t: int) -> torch.Tensor:
    """Write (P, t, t) tiles into r_pad at tile coordinates (ys, xs), in
    place, with one indexed copy; returns r_pad.  Duplicate coordinates
    carry identical tiles, so write order does not matter."""
    m_r, m_c = r_pad.shape[0] // t, r_pad.shape[1] // t
    r4 = r_pad.view(m_r, t, m_c, t)
    dev = r_pad.device
    r4[torch.as_tensor(ys, device=dev), :,
       torch.as_tensor(xs, device=dev), :] = tiles.to(r_pad.dtype)
    return r_pad


def symmetrize(r_pad: torch.Tensor, n: int) -> torch.Tensor:
    """Mirror the upper triangle into the lower one and crop to (n, n).

    Element for element the reference's ``where(i <= j, r, r.T)[:n, :n]``,
    done in place on r_pad band by band: each band's strictly-lower
    off-diagonal block copies the transpose of its upper twin, and the
    band's diagonal block takes its own upper half mirrored.
    """
    n_pad = r_pad.shape[0]
    for i0 in range(0, n_pad, _BAND):
        i1 = min(n_pad, i0 + _BAND)
        if i0:
            r_pad[i0:i1, :i0].copy_(r_pad[:i0, i0:i1].T)
        blk = r_pad[i0:i1, i0:i1]
        upper = torch.ones((i1 - i0, i1 - i0), dtype=torch.bool,
                           device=r_pad.device).triu_()
        blk.copy_(torch.where(upper, blk, blk.T))
    return r_pad[:n, :n].contiguous()


class DenseSink(TileSink):
    """Accumulate tiles into a padded device matrix; result() is the
    symmetrised (n, n) similarity."""

    def open(self, plan: ExecutionPlan, device: torch.device) -> None:
        super().open(plan, device)
        self.r_pad = torch.zeros((plan.n_pad, plan.n_pad), dtype=torch.float32,
                                 device=device)

    def consume(self, ids: np.ndarray, tiles: torch.Tensor) -> None:
        ys, xs = self.plan.workload.job_coord_batch(np.asarray(ids))
        scatter_tiles_at(self.r_pad, tiles, ys, xs, self.plan.t)

    def result(self) -> torch.Tensor:
        r = symmetrize(self.r_pad, self.plan.n)
        self.r_pad = None
        # Unfused runs leave only the bounded-measure clip, elementwise, so
        # clipping after the mirror equals clipping each tile.
        meas = self.plan.measure
        if not self.plan.fused and self.plan.clip and meas.clip is not None:
            r.clamp_(*meas.clip)
        return r


__all__ = ["TileSink", "DenseSink", "scatter_tiles_at", "symmetrize"]
