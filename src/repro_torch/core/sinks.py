"""Tile sinks: what becomes of the executor's per-pass tile stream.

Port of ``TileSink``, ``DenseSink``, ``HostSink``, ``ShardedHostSink``
(with ``ShardedMatrix``, ``open_manifest`` and ``assemble``),
``ReductionSink``, ``EdgeCountSink``, ``RowBlockSink``, ``TopKSink``,
``DeviceTopKSink``, ``ExceedanceSink`` and ``topk_merge_rows`` of
``repro/core/sinks.py``.
Contract: ``open(plan, device)`` once, ``consume(ids, tiles[, ready])``
per piece of a pass (the whole pass on one device; one piece per rank over
a mesh, each on its rank's device) with the piece's unique global tile ids
while the next pass is already launched (double buffering),
``pass_complete(k)`` once every piece of pass k is consumed (durable sinks commit there; ``resume_pass()`` /
``skip_passes()`` tell the executor which passes a checkpoint already
holds; ``covered()`` reports the tile ids it holds durably and
``rebind(plan)`` adopts a re-split plan, both for the recovering
executor), ``result()`` to close the run.  Tiles arrive with the measure's
epilogue applied; bounded measures are clipped in the kernel
(fused) or by the sink (unfused) — clipping is idempotent, so both agree
bit for bit.

On the card, ``ready`` is the CUDA event the executor recorded right after
the pass's launch (None: everything queued so far).  A sink runs its own
device work on the pass, and its copies to and from the host, on a side
stream that waits on that event alone (:class:`PassStream`): it never waits
for the next pass's kernel, which the executor has already queued on the
compute stream, so the host's work on pass k overlaps the card's on pass
k + 1.  On the CPU there is no event and no stream.

  DenseSink       the (n, n) matrix (mirrored) or the (n_rows, n_cols)
                  cross matrix of a rectangular run, on the device.
  HostSink        the same matrix on the host: a caller array, a new
                  ndarray, or an np.memmap at `path` whose passes are
                  committed crash-atomically and resumed
                  (``corr(resume_from=path)``).
  ShardedHostSink one host's tile-id range of the result as chunk files
                  and a manifest, crash-safe and resumable; ``assemble``
                  / ``open_manifest`` read a directory of shards back.
  ReductionSink   a caller's fold over the tile stream (host numpy
                  tiles), state whatever the fold returns.
  EdgeCountSink   the thresholded network's edge count, degrees and
                  intra-label edges, counted on the device: O(n) state.
  RowBlockSink    row ranges of a rectangular run, each in its own host
                  array (the serving batcher's scatter).
  TopKSink        the k strongest-|r| partners of every row, O(n_rows * k)
                  host state, fed by the tile stream.
  DeviceTopKSink  the same result fed by the top-k kernel's per-pass state
                  (kernels/pcc_tile.pcc_topk_tiles): O(n * k) per pass
                  leaves the card instead of the tiles.
  ExceedanceSink  a significance run's p-value leg: per-pass null
                  exceedance counts -> p-value tiles -> an inner sink.

Over a mesh a sink's device state (DenseSink's matrix, EdgeCountSink's
counts) lies on the mesh's first device, and a piece from another card
reaches it through ``PassStream.fetch``; host sinks copy each piece to the
host from its own card.

Unlike the reference's functional scatter and ``where``-mirror, DenseSink
scatters and mirrors in place on its padded device matrix: no second and
third (n_pad, n_pad) buffer, which keeps n = 64K inside 80 GB.
"""

from __future__ import annotations

import abc
import contextlib
import copy
import json
import os
import zlib
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import mapping
from repro_torch.core.plan import ExecutionPlan, needs_row_scales
from repro_torch.kernels.pcc_tile import topk_fold_states
from repro_torch.runtime import faults

# Rows per band of the in-place mirror: bounds the temporary of a diagonal
# block at _BAND^2 floats.
_BAND = 2048
# Tiles per chunk of EdgeCountSink's device count: bounds its boolean and
# |r| temporaries at _EDGE_CHUNK * t^2 elements (34 MB of |r| at t = 256).
_EDGE_CHUNK = 128


class PassStream:
    """Where a sink's work on one pass piece runs.

    On the card: a side stream of the piece's device that waits on the
    piece's ``ready`` event (recorded after its launch), so the sink's
    device work and copies queue behind that piece alone and not behind
    the next pass's kernels.  Host arrays reach the card as non-blocking
    copies from pinned memory, and results reach the host through pinned
    buffers, the host waiting on those copies only.  Every pass buffer used
    on a side stream is kept alive for it (``record_stream``); :meth:`join`
    orders the sink's own device's current stream after its side stream.
    A piece computed on another card of a mesh reaches the sink's own card
    through :meth:`fetch`.  On the CPU every method is the plain operation.
    """

    def __init__(self, device: torch.device):
        self.device = device
        self._streams = {}
        self.stream = self._side(device)

    def _side(self, dev: torch.device):
        """The side stream on `dev` (made on first use), None on the CPU."""
        if dev.type != "cuda":
            return None
        stream = self._streams.get(dev)
        if stream is None:
            stream = self._streams[dev] = torch.cuda.Stream(dev)
        return stream

    @contextlib.contextmanager
    def pass_of(self, ready, *bufs: torch.Tensor):
        """Run the block on the side stream of the device holding `bufs`
        (the sink's own without bufs), after ``ready`` (an event, or None
        for everything queued so far on that device's current stream)."""
        dev = bufs[0].device if bufs else self.device
        stream = self._side(dev)
        if stream is None:
            yield
            return
        if ready is None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(dev))
        stream.wait_event(ready)
        for buf in bufs:
            buf.record_stream(stream)
        with torch.cuda.stream(stream):
            yield

    def fetch(self, buf: torch.Tensor, ready):
        """``(buf, ready)`` for a piece on the sink's own device: as given
        when it lies there; from another card, a copy queued after
        ``ready`` on the side streams of both cards (peer to peer where the
        cards allow it), with the event that follows the copy; a host
        tensor, copied.  A failed copy raises."""
        if buf.device == self.device:
            return buf, ready
        if buf.device.type != "cuda" or self.stream is None:
            return buf.to(self.device), None
        with self.pass_of(ready, buf), torch.cuda.stream(self.stream):
            out = buf.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        return out, done

    def to_card(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the sink's device, copied without blocking the
        host (inside :meth:`pass_of` of that device)."""
        host = torch.from_numpy(np.ascontiguousarray(a))
        if self.stream is None:
            return host
        return host.pin_memory().to(self.device, non_blocking=True)

    def to_host(self, *tensors: torch.Tensor) -> List[np.ndarray]:
        """The tensors (on one device) as numpy arrays: on the card, copies
        on that device's side stream into pinned buffers, and the host
        waits for those alone."""
        stream = self._side(tensors[0].device)
        if stream is None:
            return [t.numpy() for t in tensors]
        outs = []
        with torch.cuda.stream(stream):
            for t in tensors:
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t, non_blocking=True)
                outs.append(host)
            done = torch.cuda.Event()
            done.record(stream)
        done.synchronize()
        return [h.numpy() for h in outs]

    def join(self) -> None:
        """Order the current stream after the side stream's work."""
        if self.stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(self.stream)


def after(ready, *bufs: torch.Tensor) -> None:
    """Order the current stream of the device holding `bufs` after
    ``ready`` (a piece's event; None: nothing to wait for), and keep the
    bufs alive for it: work queued there next reads the piece."""
    if ready is None or bufs[0].device.type != "cuda":
        return
    stream = torch.cuda.current_stream(bufs[0].device)
    stream.wait_event(ready)
    for buf in bufs:
        buf.record_stream(stream)


class TileSink(abc.ABC):
    """Consumes the executor's per-pass tile stream."""

    plan: ExecutionPlan

    def open(self, plan: ExecutionPlan, device: torch.device) -> None:
        """Called once before the first pass; allocate state here."""
        self.plan = plan

    def resume_pass(self) -> int:
        """First pass the executor should run: 0 unless the sink recovered
        persisted progress in open() (HostSink checkpoints); passes below
        it are never launched."""
        return 0

    def skip_passes(self) -> set:
        """Passes at or past resume_pass() that the executor must not
        launch: empty unless the recovered coverage is not a prefix of
        passes (a corrupt region dropped from a checkpoint)."""
        return set()

    def covered(self) -> Optional[np.ndarray]:
        """Bool bitmap over tile ids whose output this sink already holds
        durably, or None for sinks without recoverable coverage."""
        return None

    def rebind(self, new_plan: ExecutionPlan) -> None:
        """Adopt a re-split plan mid-run (the same geometry, measure and
        workload; only the pass split changed, after an out-of-memory
        error or a device loss).  Durable sinks re-commit their progress
        under the new spec at once, so a crash after the change resumes
        against the plan that will run."""
        self.plan = new_plan

    def pass_complete(self, k: int) -> None:
        """Pass k's tiles have been consumed; durable sinks commit here."""

    @abc.abstractmethod
    def consume(self, ids: np.ndarray, tiles: torch.Tensor,
                ready=None) -> None:
        """One piece of a pass (the whole pass on one device, one rank's
        part of it on a mesh): ids (P,) unique global tile ids, ascending;
        tiles (P, t, t) on any device of the run (epilogue applied;
        clipped iff fused); ready the CUDA event recorded after the
        piece's launch, or None."""

    def consume_clamped(self, padded_ids: np.ndarray, sel: np.ndarray,
                        ids: np.ndarray, tiles: torch.Tensor) -> None:
        """The reference's mesh pass with clamped tail slots: `sel` indexes
        the valid slots of the (p * launch, t, t) buffer, whose ids are
        `ids`.  Filtered on the host, then consumed.  The port's executor
        launches only valid slots and never calls this; it is kept for
        the sink contract."""
        del padded_ids
        host = tiles.cpu().numpy() if isinstance(tiles, torch.Tensor) \
            else np.asarray(tiles)
        self.consume(ids, torch.from_numpy(host[np.asarray(sel)]))

    @abc.abstractmethod
    def result(self):
        """Finalise and return the run's output."""


def scatter_tiles_at(r_pad: torch.Tensor, tiles: torch.Tensor, ys, xs,
                     t: int) -> torch.Tensor:
    """Write (P, t, t) tiles into r_pad at tile coordinates (ys, xs), host
    arrays or index tensors, in place, with one indexed copy; returns
    r_pad.  Duplicate coordinates carry identical tiles, so write order
    does not matter."""
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
    symmetrised (n, n) similarity for the triangular workload, or the
    cropped (n_rows, n_cols) cross-similarity for the rectangular one
    (nothing to mirror)."""

    def open(self, plan: ExecutionPlan, device: torch.device) -> None:
        super().open(plan, device)
        self.r_pad = torch.zeros((plan.n_pad, plan.col_pad),
                                 dtype=torch.float32, device=device)
        self._side = PassStream(device)

    def consume(self, ids: np.ndarray, tiles: torch.Tensor,
                ready=None) -> None:
        ys, xs = self.plan.workload.job_coord_batch(np.asarray(ids))
        tiles, ready = self._side.fetch(tiles, ready)
        with self._side.pass_of(ready, tiles):
            scatter_tiles_at(self.r_pad, tiles, self._side.to_card(ys),
                             self._side.to_card(xs), self.plan.t)

    def result(self) -> torch.Tensor:
        self._side.join()
        if self.plan.workload.needs_symmetrize:
            r = symmetrize(self.r_pad, self.plan.n)
        else:
            r = self.r_pad[:self.plan.n_rows, :self.plan.n_cols].contiguous()
        self.r_pad = None
        # Unfused runs leave only the bounded-measure clip, elementwise, so
        # clipping after the mirror equals clipping each tile.
        meas = self.plan.measure
        if not self.plan.fused and self.plan.clip and meas.clip is not None:
            r.clamp_(*meas.clip)
        return r


def _tile_runs(ys: np.ndarray, xs: np.ndarray):
    """(start, stop) of the maximal runs of a tile batch that lie side by
    side in one tile row (the same y, consecutive x): each run is one
    rectangle of the matrix."""
    cut = np.nonzero((np.diff(ys) != 0) | (np.diff(xs) != 1))[0] + 1
    return zip(np.concatenate([[0], cut]).tolist(),
               np.concatenate([cut, [len(ys)]]).tolist())


def place_tiles_host(r: np.ndarray, tiles: np.ndarray, ys: np.ndarray,
                     xs: np.ndarray, t: int, mirror: bool = True) -> None:
    """Write a batch of (t, t) tiles (and, for symmetric workloads, the
    transposes of the off-diagonal ones) into the host matrix r in place;
    plain arrays and np.memmap alike.  The reference's fancy-index
    assignment, written as one slice assignment per run of tiles side by
    side in a tile row (a pass of consecutive ids is a few such runs), so
    the host copies rows instead of gathering single elements.
    mirror=False for rectangular workloads, whose grid has no transpose
    twin."""
    for a, b in _tile_runs(ys, xs):
        y, x0 = int(ys[a]), int(xs[a])
        x1 = x0 + b - a
        r[y * t:(y + 1) * t, x0 * t:x1 * t] = \
            tiles[a:b].transpose(1, 0, 2).reshape(t, -1)
        if mirror:
            a0 = a + int(x0 == y)          # a diagonal tile has no twin
            if a0 < b:
                r[(x1 - (b - a0)) * t:x1 * t, y * t:(y + 1) * t] = \
                    tiles[a0:b].transpose(0, 2, 1).reshape(-1, t)


def _id_intervals(ids: np.ndarray) -> List[List[int]]:
    """A sorted unique id array as half-open ``[lo, hi)`` runs: the
    sidecar's encoding of tile regions (global ids, not pass indices)."""
    if ids.size == 0:
        return []
    breaks = np.nonzero(np.diff(ids) != 1)[0]
    starts = np.concatenate([[0], breaks + 1])
    ends = np.concatenate([breaks, [ids.size - 1]])
    return [[int(ids[s]), int(ids[e]) + 1] for s, e in zip(starts, ends)]


def _ids_from_intervals(ivs) -> np.ndarray:
    parts = [np.arange(int(lo), int(hi), dtype=np.int64) for lo, hi in ivs]
    return np.concatenate(parts) if parts else np.empty(0, np.int64)


def _chunk_crc(tiles: np.ndarray) -> int:
    """CRC32 of a chunk's float32 tile bytes, C order."""
    return zlib.crc32(np.ascontiguousarray(tiles, np.float32)) & 0xFFFFFFFF


def _fsync_dir(d: str) -> None:
    """Persist a rename in directory `d`, where the filesystem allows a
    directory fsync."""
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class HostSink(TileSink):
    """Assemble tiles (and, for symmetric workloads, their mirrors) into a
    host matrix: a caller array `out`, an np.memmap at `path`, or a new
    ndarray.  Device memory stays bounded by one pass; the whole result
    lives on the host or on disk, so it may exceed the card's memory.

    Each pass's tiles reach the host through :class:`PassStream`: the copy
    runs on the side stream behind that pass's own event, and ``consume``
    waits on that copy alone, so the next pass's kernel, already queued,
    runs while the host writes this one.

    Checkpoint and resume, the reference's version-2 sidecar, so either
    package resumes the other's checkpoint.  With a memmap `path`, every
    completed pass is committed durably and crash-atomically: the memmap
    is flushed, then ``<path>.progress.json`` is written to a temporary
    file, fsynced, renamed into place and the directory fsynced (a crash
    at any instant leaves the old or the new sidecar, never a truncated
    one).  The sidecar holds the plan spec (``ExecutionPlan.spec_dict()``),
    the last completed pass and one coverage entry per commit: the tile-id
    intervals it committed and a CRC32 of their tile regions.
    ``HostSink(path=..., resume=True)`` (or ``corr(..., resume_from=path)``)
    refuses a spec that differs from the run's, re-verifies every entry's
    CRC against the memmap, drops corrupt regions (they are recomputed,
    never trusted) and tells the executor which passes to run: completed
    passes are never launched again, and a run killed mid-pass reruns only
    that pass.  A version-1 sidecar (no coverage entries) is trusted for
    its completed-pass prefix, as the reference trusts it, and upgraded to
    version 2 with one verified entry.  Entries are keyed by tile ids, not
    pass indices, so a checkpoint taken before a re-split (``rebind``)
    resumes under the new plan.

    Fault sites (runtime/faults.py), the reference's: ``sink_write`` (the
    tile write, after the host copy; a partial write lands a prefix of the
    batch and leaves the pass uncommitted), ``sink_flush`` (before the
    memmap flush) and ``sink_commit`` (between the temporary sidecar's
    fsync and its rename: a crash there leaves the previous sidecar).
    """

    SIDECAR_VERSION = 2

    def __init__(self, out: Optional[np.ndarray] = None,
                 path: Optional[str] = None, resume: bool = False):
        if out is not None and path is not None:
            raise ValueError("pass either a preallocated `out` or a memmap "
                             "`path`, not both")
        if resume and path is None:
            raise ValueError("resume=True requires a memmap `path` (the "
                             "progress sidecar lives next to it)")
        self._out = out
        self._path = path
        self._resume = resume

    @property
    def progress_path(self) -> Optional[str]:
        return None if self._path is None else self._path + ".progress.json"

    # -- sidecar integrity ---------------------------------------------------

    def _crc_of_ids(self, ids: np.ndarray) -> int:
        """CRC32 over the tile regions of `ids` in the order given
        (ascending), each tile's t x t block row-major: the reference's
        bytes, read run by run.  Mirrors are derived writes and are left
        out: recomputing a dropped region rewrites both."""
        ids = np.asarray(ids, np.int64)
        if ids.size == 0:
            return 0
        ys, xs = self.plan.workload.job_coord_batch(ids)
        t = self.plan.t
        crc = 0
        for a, b in _tile_runs(ys, xs):
            y, x0 = int(ys[a]), int(xs[a])
            block = self.r[y * t:(y + 1) * t, x0 * t:(x0 + b - a) * t]
            tiles = block.reshape(t, b - a, t).transpose(1, 0, 2)
            crc = zlib.crc32(np.ascontiguousarray(tiles, np.float32), crc)
        return crc & 0xFFFFFFFF

    def _write_progress(self, completed: int) -> None:
        # the data is flushed before the watermark advances: a crash between
        # the two leaves a pass marked incomplete (rerun), never a pass
        # marked complete with unflushed tiles
        faults.check("sink_flush")
        if hasattr(self.r, "flush"):
            self.r.flush()
        tmp = self.progress_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"version": self.SIDECAR_VERSION,
                       "spec": self.plan.spec_dict(),
                       "completed": completed,
                       "entries": self._entries}, f)
            f.flush()
            os.fsync(f.fileno())
        # a fault here is a crash after the temporary write and before the
        # commit: the previous sidecar stays whole and resumable
        faults.check("sink_commit")
        os.replace(tmp, self.progress_path)
        _fsync_dir(os.path.dirname(os.path.abspath(self.progress_path)))

    def _load_sidecar(self) -> dict:
        try:
            with open(self.progress_path) as f:
                state = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise ValueError(
                f"cannot resume from {self._path!r}: progress sidecar "
                f"unreadable ({e}).  The sidecar commit is atomic, so a "
                f"crash cannot truncate it: it is missing or was modified "
                f"outside the engine.  Delete {self.progress_path!r} and "
                f"the memmap to restart from scratch.") from None
        bad = None
        if not isinstance(state, dict):
            bad = f"expected a JSON object, got {type(state).__name__}"
        elif not isinstance(state.get("spec"), dict):
            bad = "missing plan spec"
        elif not isinstance(state.get("completed"), int):
            bad = "missing completed-pass watermark"
        elif not isinstance(state.get("entries", []), list) or any(
                not isinstance(e, dict) for e in state.get("entries", [])):
            bad = "malformed coverage entries"
        if bad is not None:
            raise ValueError(
                f"cannot resume from {self._path!r}: progress sidecar "
                f"garbled ({bad}).  Delete {self.progress_path!r} and the "
                f"memmap to restart from scratch.")
        return state

    def open(self, plan: ExecutionPlan, device: torch.device) -> None:
        super().open(plan, device)
        self._side = PassStream(device)
        shape = (plan.n_pad, plan.col_pad)
        self._completed = -1
        self._skip: set = set()
        self._entries: List[dict] = []
        self._pending: List[np.ndarray] = []
        self._covered = np.zeros(plan.total_tiles, bool)
        if self._out is not None:
            if self._out.shape != shape:
                raise ValueError(
                    f"out shape {self._out.shape} != padded {shape}")
            self.r = self._out
        elif self._path is not None:
            if self._resume:
                self._open_resume(shape)
            else:
                # "w+" truncates and extends the file: it reads as zeros
                self.r = np.memmap(self._path, dtype=np.float32, mode="w+",
                                   shape=shape)
                self._write_progress(-1)
        else:
            self.r = np.zeros(shape, np.float32)

    def _open_resume(self, shape) -> None:
        state = self._load_sidecar()
        spec = self.plan.spec_dict()
        if state["spec"] != spec:
            raise ValueError(
                f"cannot resume from {self._path!r}: persisted plan "
                f"spec {state['spec']} does not match the requested run "
                f"{spec}")
        self.r = np.memmap(self._path, dtype=np.float32, mode="r+",
                           shape=shape)
        v1 = state.get("version", 1) < 2
        if v1:
            # a version-1 sidecar (no CRCs): trust its completed-pass
            # prefix, its own semantics, as one entry verified from here on
            parts = [self.plan.pass_selection(k)[0]
                     for k in range(int(state["completed"]) + 1)]
            ids = (np.unique(np.concatenate(parts)) if parts
                   else np.empty(0, np.int64))
            entries = [{"iv": _id_intervals(ids),
                        "crc": self._crc_of_ids(ids)}]
        else:
            entries = state.get("entries", [])
        dropped = 0
        for e in entries:
            ids = _ids_from_intervals(e.get("iv", []))
            if ids.size and (ids[0] < 0
                             or ids[-1] >= self.plan.total_tiles):
                dropped += 1
                continue
            if int(e.get("crc", -1)) != self._crc_of_ids(ids):
                dropped += 1  # a corrupt region: recompute it
                continue
            self._covered[ids] = True
            self._entries.append(e)
        k0, self._skip = self.plan.coverage_schedule(self._covered)
        self._completed = k0 - 1
        if dropped or v1:
            # prune the corrupt entries (and upgrade a version 1) durably,
            # so a crash now never trusts a known-bad region again
            self._write_progress(self._completed)

    # -- executor contract ---------------------------------------------------

    def resume_pass(self) -> int:
        return self._completed + 1

    def skip_passes(self) -> set:
        return set(self._skip)

    def covered(self) -> np.ndarray:
        return self._covered.copy()

    def rebind(self, new_plan: ExecutionPlan) -> None:
        """Adopt a re-split plan mid-run: the tiles consumed and not yet
        committed are committed first (their bytes are in ``self.r``; the
        flush makes them durable before the sidecar moves), then the
        schedule is derived anew and the sidecar rewritten under the new
        spec."""
        self.plan = new_plan
        self._commit_pending()
        k0, self._skip = new_plan.coverage_schedule(self._covered)
        self._completed = k0 - 1
        if self._path is not None:
            self._write_progress(self._completed)

    def _commit_pending(self) -> None:
        if not self._pending:
            return
        ids = np.unique(np.concatenate(self._pending))
        self._pending = []
        self._covered[ids] = True
        if self._path is not None:
            self._entries.append({"iv": _id_intervals(ids),
                                  "crc": self._crc_of_ids(ids)})

    def pass_complete(self, k: int) -> None:
        self._completed = k
        self._commit_pending()
        if self._path is not None:
            self._write_progress(k)

    def _place(self, ids: np.ndarray, vals: np.ndarray) -> None:
        if ids.size == 0:
            return
        ys, xs = self.plan.workload.job_coord_batch(ids)
        place_tiles_host(self.r, vals, ys, xs, self.plan.t,
                         mirror=self.plan.workload.needs_symmetrize)

    def consume(self, ids: np.ndarray, tiles: torch.Tensor,
                ready=None) -> None:
        ids = np.asarray(ids, dtype=np.int64)
        with self._side.pass_of(ready, tiles):
            vals, = self._side.to_host(tiles)
        fault = faults.poll("sink_write")
        if isinstance(fault, faults.PartialWriteFault):
            # a prefix lands, then the write fails: the pass is never
            # committed, so the partial region stays uncovered (rerun)
            cut = int(len(ids) * fault.fraction)
            self._place(ids[:cut], vals[:cut])
            raise fault
        if fault is not None:
            raise fault
        self._place(ids, vals)
        self._pending.append(ids)

    def result(self) -> np.ndarray:
        r = self.r[:self.plan.n_rows, :self.plan.n_cols]
        meas = self.plan.measure
        if self.plan.clip and meas.clip is not None:
            np.clip(r, meas.clip[0], meas.clip[1], out=r)
        return r


class ShardedHostSink(TileSink):
    """Multi-host output sharding: each host persists only its disjoint
    tile-id range of the result, as chunk ``.npy`` files and a JSON
    manifest, so no host holds or writes more than its 1/n_hosts slice of
    the n x n result (CoMet's disjoint per-node output shards,
    arXiv:1705.08213).

    Ownership is ``plan.host_tile_range(host, n_hosts)``: over a mesh of
    p ranks (n_hosts dividing p), the union of the host's p / n_hosts
    ranks' ranges; on one device, the ceil split of the tile ids.  It is
    frozen at ``open()``: a re-split mid-run (``rebind``, after an
    out-of-memory error or a mesh shrink) keeps it, or two hosts could
    claim one tile.  The hosts are simulated by running the same plan once
    per host: each runs only the passes that hold its tiles (the others'
    tiles report as covered), and a pass across a range boundary runs on
    both hosts.

    Durability extends HostSink's sidecar: every completed pass commits
    one chunk file (its owned tiles in ascending id order, ``np.save`` to a
    temporary name, fsynced, renamed) and rewrites the host's manifest
    ``manifest.h<host>.json`` atomically, with the plan spec, the frozen
    range and one ``{file, iv, crc}`` entry a chunk (CRC32 of the chunk's
    tile bytes).  ``resume=True`` checks the spec's content part
    (:meth:`content_spec`: the pass split may differ), re-verifies every
    chunk's CRC, drops and recomputes corrupt chunks, and reports the
    resume schedule through the coverage contract, so kill-and-resume and
    ``recovery=RetryPolicy()`` compose as for HostSink.  File names and
    JSON keys are the reference's: a shard written by either package
    resumes and assembles in the other.

    Each pass's owned tiles reach the host through :class:`PassStream`,
    behind the pass's own event.  Fault sites: ``sink_write`` (staging the
    tiles; partial writes), ``sink_flush`` (the chunk write),
    ``sink_commit`` (before the manifest's rename).  :func:`open_manifest`
    and :func:`assemble` read the shards back, by row range or whole.
    """

    MANIFEST_VERSION = 1

    # a re-split changes the pass split without changing a bit of the
    # output, so shard identity (resume, agreement of manifests) ignores it
    _DISTRIBUTION_KEYS = frozenset({"p", "max_tiles_per_pass", "n_pass"})

    @classmethod
    def content_spec(cls, spec: dict) -> dict:
        """The output-identity part of a plan's spec_dict."""
        return {k: v for k, v in spec.items()
                if k not in cls._DISTRIBUTION_KEYS}

    def __init__(self, dir: str, host: int = 0, n_hosts: int = 1,
                 resume: bool = False):
        if n_hosts <= 0:
            raise ValueError(f"n_hosts must be positive, got {n_hosts}")
        if not 0 <= host < n_hosts:
            raise ValueError(f"host {host} out of range for {n_hosts} hosts")
        self._dir = dir
        self._host = int(host)
        self._n_hosts = int(n_hosts)
        self._resume = resume

    @property
    def manifest_path(self) -> str:
        return os.path.join(self._dir, f"manifest.h{self._host}.json")

    def open(self, plan: ExecutionPlan, device: torch.device) -> None:
        super().open(plan, device)
        self._side = PassStream(device)
        os.makedirs(self._dir, exist_ok=True)
        self._chunks: List[dict] = []
        self._pending: List[tuple] = []
        self._covered = np.zeros(plan.total_tiles, bool)
        if self._resume:
            self._open_resume()
        else:
            self._lo, self._hi = plan.host_tile_range(self._host,
                                                      self._n_hosts)
            self._mark_foreign()
            self._write_manifest()
        k0, self._skip = plan.coverage_schedule(self._covered)
        self._completed = k0 - 1

    def _mark_foreign(self) -> None:
        # the other hosts' tiles are theirs: reported covered, so this
        # host's executor runs its own passes only
        self._covered[:self._lo] = True
        self._covered[self._hi:] = True

    def _write_manifest(self) -> None:
        meas = self.plan.measure
        clip = (list(meas.clip)
                if self.plan.clip and meas.clip is not None else None)
        doc = {"version": self.MANIFEST_VERSION,
               "spec": self.plan.spec_dict(),
               "host": self._host, "n_hosts": self._n_hosts,
               "range": [int(self._lo), int(self._hi)],
               "clip_range": clip,
               "chunks": self._chunks}
        tmp = self.manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
            f.flush()
            os.fsync(f.fileno())
        faults.check("sink_commit")
        os.replace(tmp, self.manifest_path)
        _fsync_dir(self._dir)

    def _open_resume(self) -> None:
        try:
            with open(self.manifest_path) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise ValueError(
                f"cannot resume shard: manifest {self.manifest_path!r} "
                f"unreadable ({e}).  The manifest commit is atomic; delete "
                f"the shard directory to restart this host from scratch."
            ) from None
        spec = self.plan.spec_dict()
        if self.content_spec(doc.get("spec") or {}) != self.content_spec(spec):
            raise ValueError(
                f"cannot resume shard {self.manifest_path!r}: persisted "
                f"plan spec {doc.get('spec')} does not match the requested "
                f"run {spec}")
        if (doc.get("host"), doc.get("n_hosts")) != (self._host,
                                                     self._n_hosts):
            raise ValueError(
                f"cannot resume shard {self.manifest_path!r}: it belongs "
                f"to host {doc.get('host')}/{doc.get('n_hosts')}, not "
                f"{self._host}/{self._n_hosts}")
        self._lo, self._hi = (int(v) for v in doc["range"])
        self._mark_foreign()
        dropped = 0
        for e in doc.get("chunks", []):
            ids = _ids_from_intervals(e.get("iv", []))
            path = os.path.join(self._dir, e.get("file", ""))
            try:
                tiles = np.load(path)
            except (OSError, ValueError):
                dropped += 1
                continue
            if (tiles.shape != (ids.size, self.plan.t, self.plan.t)
                    or int(e.get("crc", -1)) != _chunk_crc(tiles)):
                dropped += 1  # a corrupt chunk: recompute it, never trust it
                try:
                    os.remove(path)
                except OSError:
                    pass
                continue
            self._covered[ids] = True
            self._chunks.append(e)
        if dropped:
            # prune durably, so a crash now never trusts a known-bad chunk
            self._write_manifest()

    # -- executor contract ---------------------------------------------------

    def resume_pass(self) -> int:
        return self._completed + 1

    def skip_passes(self) -> set:
        return set(self._skip)

    def covered(self) -> np.ndarray:
        return self._covered.copy()

    def rebind(self, new_plan: ExecutionPlan) -> None:
        """Adopt a re-split plan: ownership stays frozen, the schedule is
        derived anew and the manifest re-committed under the new spec."""
        self.plan = new_plan
        self._commit_pending()
        k0, self._skip = new_plan.coverage_schedule(self._covered)
        self._completed = k0 - 1
        self._write_manifest()

    def _commit_pending(self) -> None:
        if not self._pending:
            return
        ids = np.concatenate([p[0] for p in self._pending])
        tiles = np.concatenate([p[1] for p in self._pending])
        # ascending and each tile once: a partial write's staged prefix and
        # its rerun carry the same tiles
        ids, first = np.unique(ids, return_index=True)
        tiles = np.ascontiguousarray(tiles[first], dtype=np.float32)
        fresh = ~self._covered[ids]
        if not fresh.all():
            ids, tiles = ids[fresh], tiles[fresh]
        if ids.size == 0:
            self._pending = []
            return
        name = f"chunk-{int(ids[0]):010d}-{int(ids[-1]):010d}.npy"
        faults.check("sink_flush")
        tmp = os.path.join(self._dir, name + ".tmp")
        with open(tmp, "wb") as f:
            np.save(f, tiles)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self._dir, name))
        # cleared only once written: the executor counts a consumed pass as
        # covered, so tiles whose chunk write failed go with the next one
        self._pending = []
        self._covered[ids] = True
        self._chunks.append({"file": name, "iv": _id_intervals(ids),
                             "crc": _chunk_crc(tiles)})

    def pass_complete(self, k: int) -> None:
        self._completed = k
        self._commit_pending()
        self._write_manifest()

    def consume(self, ids: np.ndarray, tiles: torch.Tensor,
                ready=None) -> None:
        ids = np.asarray(ids, dtype=np.int64)
        # a pass's ids ascend, so the owned ones are one slice of it
        a, b = (int(i) for i in np.searchsorted(ids, [self._lo, self._hi]))
        if a == b:
            return
        with self._side.pass_of(ready, tiles):
            vals, = self._side.to_host(tiles[a:b])
        fault = faults.poll("sink_write")
        if isinstance(fault, faults.PartialWriteFault):
            cut = int((b - a) * fault.fraction)
            self._pending.append((ids[a:a + cut], vals[:cut]))
            raise fault
        if fault is not None:
            raise fault
        self._pending.append((ids[a:b], vals))

    def result(self) -> dict:
        own = int(self._covered[self._lo:self._hi].sum())
        return {"dir": self._dir, "manifest": self.manifest_path,
                "host": self._host, "n_hosts": self._n_hosts,
                "range": (self._lo, self._hi), "tiles": own,
                "complete": own == self._hi - self._lo}


def _put_block(out: np.ndarray, lo: int, r0: int, c0: int, rows: int,
               build: Callable[[], np.ndarray]) -> None:
    """Write the `rows`-row block ``build()`` whose first element sits at
    (r0, c0) of the result into ``out``, which holds result rows [lo, lo +
    len(out)), cropped to those rows and to out's columns; a block that
    misses the rows is never built."""
    a, b = max(lo, r0), min(lo + out.shape[0], r0 + rows)
    if a >= b or c0 >= out.shape[1]:
        return
    blk = build()
    w = min(out.shape[1] - c0, blk.shape[1])
    out[a - lo:b - lo, c0:c0 + w] = blk[a - r0:b - r0, :w]


class ShardedMatrix:
    """Lazy reader over a ShardedHostSink output directory.

    Checks that every host's manifest describes the same run (the content
    part of the spec), verifies each chunk's CRC as it is read (a corrupt
    chunk is refused with an error naming the file, never filled with
    zeros), and assembles the whole (n_rows, n_cols) matrix or any row
    range, holding no more than the requested rows and one chunk.  The
    reference's result, written a run of side-by-side tiles at a time
    (:func:`place_tiles_host`'s slices) instead of element by element.
    """

    def __init__(self, manifests: List[dict], dir: str):
        if not manifests:
            raise ValueError(f"no manifest.h*.json found in {dir!r}")
        self._dir = dir
        spec0 = manifests[0]["spec"]
        for d in manifests[1:]:
            if (ShardedHostSink.content_spec(d["spec"])
                    != ShardedHostSink.content_spec(spec0)):
                raise ValueError(
                    f"shard manifests disagree on the plan spec "
                    f"({dir!r}): {spec0} vs {d['spec']}: these shards "
                    f"come from different runs")
        self.spec = spec0
        self.n_rows = int(spec0["n_rows"])
        self.n_cols = int(spec0["n_cols"])
        self.t = int(spec0["t"])
        self.total_tiles = int(spec0["total_tiles"])
        self.symmetric = spec0["workload"] == "TriangularWorkload"
        self.clip_range = manifests[0].get("clip_range")
        self.hosts = sorted(int(d["host"]) for d in manifests)
        self.ranges = {int(d["host"]): tuple(int(v) for v in d["range"])
                       for d in manifests}
        self._m = -(-self.n_rows // self.t)
        self._mc = -(-self.n_cols // self.t)
        self._chunks = []
        for d in manifests:
            for e in d.get("chunks", []):
                ids = _ids_from_intervals(e.get("iv", []))
                self._chunks.append(
                    (os.path.join(dir, e["file"]), ids, int(e["crc"])))

    def _coords(self, ids: np.ndarray):
        if self.symmetric:
            return mapping.job_coord_batch(self._m, ids)
        return ids // self._mc, ids % self._mc

    def _load(self, path: str, ids: np.ndarray, crc: int) -> np.ndarray:
        try:
            tiles = np.load(path)
        except (OSError, ValueError) as e:
            raise ValueError(
                f"shard chunk {path!r} unreadable ({e}): re-run the "
                f"owning host with resume=True to recompute it") from None
        if (tiles.shape != (ids.size, self.t, self.t)
                or _chunk_crc(tiles) != crc):
            raise ValueError(
                f"shard chunk {path!r} fails its manifest CRC: refusing "
                f"corrupt data; re-run the owning host with resume=True to "
                f"recompute exactly this chunk")
        return np.ascontiguousarray(tiles, np.float32)

    def _check_complete(self, need: np.ndarray) -> None:
        have = np.zeros(self.total_tiles, bool)
        for _, ids, _ in self._chunks:
            have[ids] = True
        missing = need & ~have
        if missing.any():
            ivs = _id_intervals(np.nonzero(missing)[0].astype(np.int64))
            raise ValueError(
                f"shards in {self._dir!r} are incomplete for the requested "
                f"rows: missing tile ids {ivs[:5]}"
                f"{'...' if len(ivs) > 5 else ''}")

    def rows(self, lo: int, hi: int) -> np.ndarray:
        """Rows [lo, hi) of the result: the only state built is the
        (hi - lo, n_cols) output and one chunk at a time."""
        if not 0 <= lo <= hi <= self.n_rows:
            raise ValueError(f"row range [{lo}, {hi}) outside "
                             f"[0, {self.n_rows})")
        t = self.t
        ys_all, xs_all = self._coords(np.arange(self.total_tiles,
                                                dtype=np.int64))
        hit = (ys_all * t < hi) & (ys_all * t + t > lo)
        if self.symmetric:
            hit |= (xs_all * t < hi) & (xs_all * t + t > lo)
        self._check_complete(hit)
        out = np.zeros((hi - lo, self.n_cols), np.float32)
        for path, ids, crc in self._chunks:
            if not hit[ids].any():
                continue
            tiles = self._load(path, ids, crc)
            ys, xs = self._coords(ids)
            for a, b in _tile_runs(ys, xs):
                y, x0 = int(ys[a]), int(xs[a])
                x1 = x0 + b - a
                # the run as one (t, (b - a) t) block at (y t, x0 t) ...
                _put_block(out, lo, y * t, x0 * t, t,
                           lambda a=a, b=b: tiles[a:b].transpose(1, 0, 2)
                           .reshape(t, -1))
                # ... and on the triangle its off-diagonal tiles' mirrors,
                # one ((b - a0) t, t) block at (x t, y t)
                a0 = a + int(x0 == y)
                if self.symmetric and a0 < b:
                    _put_block(out, lo, (x1 - (b - a0)) * t, y * t,
                               (b - a0) * t, lambda a0=a0, b=b: tiles[a0:b]
                               .transpose(0, 2, 1).reshape(-1, t))
        if self.clip_range is not None:
            np.clip(out, self.clip_range[0], self.clip_range[1], out=out)
        return out

    def full(self) -> np.ndarray:
        """The complete (n_rows, n_cols) matrix: bitwise a one-host
        DenseSink / HostSink run of the same plan."""
        return self.rows(0, self.n_rows)


def open_manifest(dir: str) -> ShardedMatrix:
    """Open a ShardedHostSink output directory for (lazy) reading."""
    manifests = []
    try:
        names = sorted(os.listdir(dir))
    except OSError as e:
        raise ValueError(f"cannot open shard directory {dir!r}: {e}") \
            from None
    for name in names:
        if name.startswith("manifest.h") and name.endswith(".json"):
            with open(os.path.join(dir, name)) as f:
                manifests.append(json.load(f))
    return ShardedMatrix(manifests, dir)


def assemble(dir: str) -> np.ndarray:
    """The full matrix from a complete set of host shards."""
    return open_manifest(dir).full()


class ReductionSink(TileSink):
    """Fold the tile stream through ``fn(state, ids, tiles, ys, xs, plan)``.

    The callback gets what the reference's gets: ``tiles`` as host numpy
    (copied through :class:`PassStream`, behind the pass's own event),
    (ys, xs) the tile coordinates of the batched bijection, so one callback
    runs under both packages.  State is whatever the callback returns,
    typically O(n) or O(1).

    ``init`` is the initial state, deep-copied at every open() (a fold that
    mutates its state in place cannot leak into the next run of a reused
    sink), or a zero-argument factory called per open().
    """

    def __init__(self, fn: Callable, init):
        self._fn = fn
        self._init = init

    def open(self, plan: ExecutionPlan, device: torch.device) -> None:
        super().open(plan, device)
        self._side = PassStream(device)
        self.state = (self._init() if callable(self._init)
                      else copy.deepcopy(self._init))

    def consume(self, ids: np.ndarray, tiles: torch.Tensor,
                ready=None) -> None:
        ys, xs = self.plan.workload.job_coord_batch(np.asarray(ids))
        with self._side.pass_of(ready, tiles):
            vals, = self._side.to_host(tiles)
        self.state = self._fn(self.state, ids, vals, ys, xs, self.plan)

    def result(self):
        return self.state


class EdgeCountSink(TileSink):
    """Streaming thresholded-graph reduction: count the edges |r| >=
    threshold without the matrix.

    State is O(n) on the device: the unordered edge count, per-node
    degrees (int64) and, with per-node integer ``labels``, the intra-label
    edge count (precision of planted-module recovery is intra / (intra +
    inter)).  Each unordered pair is counted once, through the strict-upper
    predicate row < col over the triangle's tiles; padding rows and columns
    (>= n) are masked out.  Counts are integer sums, exact in any order, so
    they equal the reference's host ``np.add.at`` counts, which would copy
    every pass to the host.  |r| compares with the threshold in float32,
    as numpy 2 compares a float32 array with a Python float.  The counts
    reach the host once, in result().
    """

    def __init__(self, threshold: float,
                 labels: Optional[np.ndarray] = None):
        self.threshold = float(threshold)
        self._labels = None if labels is None else np.asarray(labels)

    def open(self, plan: ExecutionPlan, device: torch.device) -> None:
        super().open(plan, device)
        if not plan.symmetric_problem:
            raise ValueError(
                "EdgeCountSink counts unordered pairs of one variable set — "
                "it requires a symmetric problem (corr(x) or masked "
                "corr(x, where=...)), not a rectangular X-vs-Y run")
        if self._labels is not None and self._labels.shape != (plan.n,):
            raise ValueError(
                f"labels shape {self._labels.shape} != (n={plan.n},)")
        self._side = PassStream(device)
        self._thr = torch.tensor(self.threshold, dtype=torch.float32,
                                 device=device)
        self._edges = torch.zeros((), dtype=torch.int64, device=device)
        # padded, so padding rows index in range (their counts are 0)
        self._degrees = torch.zeros(plan.n_pad, dtype=torch.int64,
                                    device=device)
        self._intra = None
        self._lab = None
        if self._labels is not None:
            lab = np.full(plan.n_pad, -1, np.int64)
            lab[:plan.n] = self._labels
            self._lab = torch.from_numpy(lab).to(device)
            self._intra = torch.zeros((), dtype=torch.int64, device=device)

    def consume(self, ids: np.ndarray, tiles: torch.Tensor,
                ready=None) -> None:
        plan = self.plan
        t, n = plan.t, plan.n
        ys, xs = plan.workload.job_coord_batch(np.asarray(ids))
        tiles, ready = self._side.fetch(tiles, ready)
        with self._side.pass_of(ready, tiles):
            span = torch.arange(t, device=tiles.device)
            rows_all = self._side.to_card(ys)[:, None] * t + span   # (P, t)
            cols_all = self._side.to_card(xs)[:, None] * t + span   # (P, t)
            for c0 in range(0, tiles.shape[0], _EDGE_CHUNK):
                c1 = min(tiles.shape[0], c0 + _EDGE_CHUNK)
                rows, cols = rows_all[c0:c1], cols_all[c0:c1]
                r3, c3 = rows[:, :, None], cols[:, None, :]
                count = ((tiles[c0:c1].abs() >= self._thr)
                         & (r3 < c3) & (c3 < n))          # r < c < n
                self._edges += count.sum()
                self._degrees.index_add_(0, rows.reshape(-1),
                                         count.sum(2).reshape(-1))
                self._degrees.index_add_(0, cols.reshape(-1),
                                         count.sum(1).reshape(-1))
                if self._lab is not None:
                    same = self._lab[rows][:, :, None] == \
                        self._lab[cols][:, None, :]
                    self._intra += (count & same).sum()

    def result(self) -> dict:
        self._side.join()
        out = {"edges": int(self._edges.item()),
               "degrees": self._degrees[:self.plan.n].cpu().numpy()}
        if self._lab is not None:
            intra = int(self._intra.item())
            out["intra_edges"] = intra
            out["inter_edges"] = out["edges"] - intra
        return out


class RowBlockSink(TileSink):
    """Land a grid workload's tiles directly in independent per-range host
    arrays: the serving batcher's scatter.

    One coalesced launch computes the stacked probe rows of several
    requests against the corpus; this sink writes each request's rows into
    its own (hi - lo, n_cols) array as the tiles stream past, so no
    (rows, n_cols) intermediate exists and each result's lifetime is its
    own.  ``bounds`` are half-open global row ranges [(lo, hi), ...]; they
    may straddle tile edges, and rows outside every range are discarded.
    Each pass's tiles reach the host through :class:`PassStream`, and the
    rows of every run of tiles side by side in a tile row are written as
    slices (not the reference's element-wise fancy index): the same
    values, without gathering single elements.
    """

    def __init__(self, bounds):
        self._bounds = [(int(lo), int(hi)) for lo, hi in bounds]
        for lo, hi in self._bounds:
            if lo < 0 or hi < lo:
                raise ValueError(f"bad row range [{lo}, {hi})")

    def open(self, plan: ExecutionPlan, device: torch.device) -> None:
        super().open(plan, device)
        if plan.workload.needs_symmetrize:
            raise ValueError(
                "RowBlockSink assembles grid workloads (rectangular "
                "X-vs-Y); symmetric triangular runs mirror tiles across "
                "segments — use HostSink/DenseSink there")
        for lo, hi in self._bounds:
            if hi > plan.n_rows:
                raise ValueError(
                    f"row range [{lo}, {hi}) exceeds plan rows "
                    f"{plan.n_rows}")
        self._side = PassStream(device)
        # padded column width: tiles write whole (t, t) blocks; result()
        # crops to the true column count
        self._outs = [np.zeros((hi - lo, plan.col_pad), np.float32)
                      for lo, hi in self._bounds]

    def consume(self, ids: np.ndarray, tiles: torch.Tensor,
                ready=None) -> None:
        t = self.plan.t
        ys, xs = self.plan.workload.job_coord_batch(np.asarray(ids))
        with self._side.pass_of(ready, tiles):
            vals, = self._side.to_host(tiles)
        for a, b in _tile_runs(ys, xs):
            y0 = int(ys[a]) * t
            c0, c1 = int(xs[a]) * t, (int(xs[a]) + b - a) * t
            block = None
            for (lo, hi), out in zip(self._bounds, self._outs):
                r0, r1 = max(lo, y0), min(hi, y0 + t)
                if r0 >= r1:
                    continue
                if block is None:     # the run as one (t, (b - a) t) block
                    block = vals[a:b].transpose(1, 0, 2).reshape(t, -1)
                out[r0 - lo:r1 - lo, c0:c1] = block[r0 - y0:r1 - y0]

    def result(self) -> list:
        meas = self.plan.measure
        outs = [o[:, :self.plan.n_cols] for o in self._outs]
        if self.plan.clip and meas.clip is not None:
            for o in outs:
                np.clip(o, meas.clip[0], meas.clip[1], out=o)
        return outs


def topk_merge_rows(vals: np.ndarray, idx: np.ndarray, r_ids: np.ndarray,
                    c_ids: np.ndarray, v: np.ndarray, k: int,
                    dedup: bool = False) -> None:
    """THE canonical per-row top-k merge, in place.

    ``vals``/``idx`` are (n_rows, k) running state (index -1 = empty slot);
    (r_ids, c_ids, v) are candidate triples.  Candidates merge under the
    canonical total order — |value| desc, then column asc — so the kept
    top-k is a set function of the candidates seen: independent of pass
    partitioning, merge order and state capacity >= k, ties included.  A
    row's candidate columns must be unique and must not repeat columns it
    already holds; ``dedup=True`` drops exact (column, value) duplicates
    (adjacent under the order) before truncation.

    The reference sorts row by row in Python; here every touched row is
    one line of a fixed-width (rows, k + max candidates) array — its state,
    then its candidates in arrival order, then padding that sorts after
    everything (key NaN, column int64 max) — and one row-wise
    ``np.lexsort`` orders them all.  lexsort is stable, so each row's order
    is the reference's ``np.lexsort((cand_i, -key))`` bit for bit.
    """
    r_ids = np.asarray(r_ids)
    if r_ids.size == 0:
        return
    order = np.argsort(r_ids, kind="stable")
    r_s = r_ids[order]
    c_s = np.asarray(c_ids)[order]
    v_s = np.asarray(v)[order]
    uniq, starts, counts = np.unique(r_s, return_index=True,
                                     return_counts=True)
    width = k + int(counts.max())
    rows = len(uniq)
    cand_v = np.zeros((rows, width), dtype=vals.dtype)
    cand_i = np.full((rows, width), np.iinfo(np.int64).max, dtype=np.int64)
    cand_v[:, :k] = vals[uniq]
    cand_i[:, :k] = idx[uniq]
    line = np.repeat(np.arange(rows), counts)
    slot = k + np.arange(len(r_s)) - np.repeat(starts, counts)
    cand_v[line, slot] = v_s
    cand_i[line, slot] = c_s
    key = np.abs(cand_v)
    key[cand_i < 0] = -np.inf               # empty slots lose to any candidate
    neg = -key
    pad = np.arange(width)[None, :] >= (k + counts)[:, None]
    neg[pad] = np.nan                       # after every real entry
    sel = np.lexsort((cand_i, neg), axis=1)
    if dedup:
        ci = np.take_along_axis(cand_i, sel, axis=1)
        cv = np.take_along_axis(cand_v, sel, axis=1)
        keep = np.ones(sel.shape, bool)
        keep[:, 1:] = ~((ci[:, 1:] == ci[:, :-1]) & (ci[:, 1:] >= 0)
                        & (cv[:, 1:] == cv[:, :-1]))
        first = np.argsort(~keep, axis=1, kind="stable")
        sel = np.take_along_axis(sel, first, axis=1)
    sel = sel[:, :k]
    vals[uniq] = np.take_along_axis(cand_v, sel, axis=1)
    idx[uniq] = np.take_along_axis(cand_i, sel, axis=1)


def _tile_row_topk(vals: torch.Tensor, cols: torch.Tensor,
                   k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per line of (..., t) candidates with ascending columns (-1 masked):
    the first min(k, t) under the canonical order.  A stable descending
    sort of |v| keeps equal keys in column order; masked entries sort
    last.  Only candidates of one line reach the line's merged top-k, so
    this pre-selection changes no result."""
    key = torch.where(cols < 0, -1.0, vals.abs())
    order = torch.sort(key, dim=-1, descending=True,
                       stable=True).indices[..., :k]
    return (torch.take_along_dim(vals, order, dim=-1),
            torch.take_along_dim(cols, order, dim=-1))


class TopKSink(TileSink):
    """Streaming per-row top-k neighbours: keep the k strongest-|r| partners
    of every row without materialising the matrix — O(n_rows * k) state.

    For the triangle a tile (y, x) contributes its entries to the rows of
    block y *and* (mirrored) to the rows of block x, and self-pairs are
    excluded; rectangular workloads rank each X row's neighbours among the
    Y rows.  Each pass merges its candidates into the running top-k under
    the canonical order (|v| desc, then column asc), so the kept set does
    not depend on the pass split.

    Each tile line is first cut to its own top-k on the device (the line's
    columns are unique and ascending, so this drops only candidates that
    cannot be kept), and only those cross to the host.

    result() is {"indices": (n_rows, k) int64, "values": (n_rows, k) f32};
    rows with fewer than k valid partners pad with index -1 / value 0.
    """

    def __init__(self, k: int):
        if k <= 0:
            raise ValueError(f"k must be positive, got {k}")
        self.k = int(k)

    def open(self, plan: ExecutionPlan, device: torch.device) -> None:
        super().open(plan, device)
        self.vals = np.zeros((plan.n_rows, self.k), np.float32)
        self.idx = np.full((plan.n_rows, self.k), -1, np.int64)
        self._side = PassStream(device)

    def consume(self, ids: np.ndarray, tiles: torch.Tensor,
                ready=None) -> None:
        plan = self.plan
        t, n_r, n_c = plan.t, plan.n_rows, plan.n_cols
        ys, xs = plan.workload.job_coord_batch(np.asarray(ids))
        # side 0: tile rows ranked over the tile's columns; side 1 (the
        # triangle's off-diagonal tiles): tile columns over the tile's rows
        sides = [(slice(None), ys, xs, plan.symmetric_problem)]
        if plan.workload.needs_symmetrize:
            off = np.nonzero(ys != xs)[0]
            sides.append((off, xs[off], ys[off], False))
        picked = []
        tiles, ready = self._side.fetch(tiles, ready)
        with self._side.pass_of(ready, tiles):
            span = torch.arange(t, device=tiles.device)
            for sel, by, bx, self_mask in sides:
                vals = tiles if isinstance(sel, slice) else \
                    tiles[self._side.to_card(sel)].transpose(1, 2)
                rows = self._side.to_card(by)[:, None] * t + span  # (P, t)
                cols = (self._side.to_card(bx)[:, None] * t
                        + span)[:, None, :]                        # (P, 1, t)
                bad = (cols >= n_c) | (rows[:, :, None] >= n_r)
                if self_mask:
                    bad = bad | (cols == rows[:, :, None])
                cols = torch.where(bad, -1, cols.expand_as(vals))
                tv, tc = _tile_row_topk(vals, cols, self.k)
                picked += [tv, tc.to(torch.int32)]
        host = self._side.to_host(*picked)
        for (_sel, by, _bx, _m), tv, tc in zip(sides, host[0::2], host[1::2]):
            ok = tc >= 0
            rows = by[:, None] * t + np.arange(t)                  # (P, t)
            r_ids = np.broadcast_to(rows[:, :, None], tc.shape)[ok]
            self._merge(r_ids, tc[ok].astype(np.int64), tv[ok])

    def _merge(self, r_ids: np.ndarray, c_ids: np.ndarray,
               v: np.ndarray) -> None:
        topk_merge_rows(self.vals, self.idx, r_ids, c_ids, v, self.k)

    def result(self) -> dict:
        self.vals[self.idx < 0] = 0.0
        return {"indices": self.idx, "values": self.vals}


class DeviceTopKSink(TopKSink):
    """TopKSink fed by the device-side top-k epilogue
    (kernels/pcc_tile.pcc_topk_tiles): the executor streams per-row-block
    top-k *state* instead of tiles, so only O(n * k) crosses from the card
    per pass and no pass buffer of tiles is ever allocated.

    ``wants_device_state`` routes the executor to the top-k kernel;
    ``merge_dedups`` says the canonical merge drops exact duplicates, as a
    recovering executor that re-delivers a pass needs.

    The kernel's tile values are bitwise those of the tile kernel, and its
    selection follows the canonical order, so result() is bit-identical to
    plain TopKSink(k) on the same plan.

    Over a mesh a pass comes as one state a rank: each is brought to the
    sink's device as it arrives, and once the pass is complete the merge
    kernel folds them into one (kernels/pcc_tile.topk_fold_states), so the
    host merges one state a pass whatever the mesh's size.
    """

    wants_device_state = True
    merge_dedups = True

    @staticmethod
    def supports(plan: ExecutionPlan) -> bool:
        """Whether this plan can take the device-side top-k path (the
        predicate ``open()`` enforces): a fused plan of unscaled float32,
        bfloat16 or int8 operands on the shared tile kernel.  Quantized
        operands (int8 with row scales on non-exact_int8 measures, fp8) and
        custom tile kernels (merge-sort Kendall) cannot: neither the scale
        product nor another kernel is fused into the top-k kernel."""
        return (plan.fused and plan.measure.tile_kernel is None
                and not plan.replicas
                and not needs_row_scales(plan.measure, plan.compute_dtype))

    def open(self, plan: ExecutionPlan, device: torch.device) -> None:
        super().open(plan, device)
        if not plan.fused:
            raise ValueError(
                "DeviceTopKSink needs the fused epilogue: the in-kernel "
                "merge ranks *finalised* values (post div/clip), so an "
                "unfused plan would rank unscaled accumulator sums")
        if plan.measure.tile_kernel is not None:
            raise ValueError(
                f"DeviceTopKSink cannot run measure {plan.measure.name!r}: "
                f"custom tile kernels bypass the top-k epilogue — use "
                f"TopKSink")
        if plan.replicas:
            raise ValueError("DeviceTopKSink does not support replica "
                             "(significance) runs")
        if needs_row_scales(plan.measure, plan.compute_dtype):
            raise ValueError(
                "DeviceTopKSink does not support quantized scaled operands "
                "— the dequant outer product is not fused into the top-k "
                "merge; use TopKSink")
        self._pending = []

    def consume(self, ids: np.ndarray, state, ready=None) -> None:
        """One piece's state: (row_vals, row_cols[, col_vals, col_cols]),
        each (m, t, kk), brought to the sink's device and held until the
        pass is complete.  `ids` is the piece's valid tile set, unused for
        content (the kernel's validity guard already excluded the slots
        past the rank's range)."""
        del ids
        self._pending.append([self._side.fetch(a, ready) for a in state])

    def pass_complete(self, k: int) -> None:
        self._merge_pending()

    def rebind(self, new_plan: ExecutionPlan) -> None:
        self._merge_pending()
        super().rebind(new_plan)

    def result(self) -> dict:
        self._merge_pending()
        return super().result()

    def _merge_pending(self) -> None:
        """Merge the held states into the host state: one as it is, several
        folded on the sink's device first (their candidates are disjoint:
        each holds the tiles of its own rank)."""
        pending, self._pending = self._pending, []
        if not pending:
            return
        bufs = [a for piece in pending for a, _ in piece]
        events = [ev for piece in pending for _, ev in piece]
        with self._side.pass_of(events[0], *bufs):
            for ev in events[1:]:
                after(ev, bufs[0])
            state = [a for a, _ in pending[0]]
            if len(pending) > 1:
                state = []
                for side in range(len(pending[0]) // 2):
                    state += topk_fold_states(
                        [(piece[2 * side][0], piece[2 * side + 1][0])
                         for piece in pending])
            host = self._side.to_host(*state)
        plan = self.plan
        t, n_r = plan.t, plan.n_rows
        for sv, sc in zip(host[0::2], host[1::2]):
            sv = sv.reshape(-1, t, sv.shape[-1])
            sc = sc.reshape(sv.shape)
            blocks = np.arange(sv.shape[0])
            rows = np.broadcast_to(
                (blocks[:, None] * t + np.arange(t))[:, :, None], sv.shape)
            ok = (sc >= 0) & (rows < n_r)
            if not ok.any():
                continue
            topk_merge_rows(self.vals, self.idx, rows[ok],
                            sc[ok].astype(np.int64), sv[ok], self.k,
                            dedup=True)


class ExceedanceSink(TileSink):
    """Turn per-pass null-exceedance *count* tiles into p-value tiles and
    hand them to an inner TileSink: the significance workload's output leg
    (core/significance.py, paper SSIV).

    The significance executor accumulates, per pass, an int32 count tile
    buffer ``#{b : |R_b| >= |R_obs|}`` on the device, chunk by chunk of
    replicas.  This sink receives it once per pass, applies the add-one
    estimator p = (1 + count) / (1 + B) in float32 on the device (B from
    ``iterations`` when given, else ``plan.replicas``), and delegates the
    p-value tiles to ``inner`` (default DenseSink; every other sink too).

    Symmetric workloads: a replica's diagonal tile is not symmetric (entry
    (i, j) compares <U_i, pi(U_j)>, entry (j, i) <U_j, pi(U_i)>).  The
    canonical output keeps the elementwise upper triangle, as DenseSink's
    mirror does, so this sink mirrors each diagonal tile's upper half into
    its lower half before delegating: every inner sink then agrees.

    open() expects the p-value plan of the executor, whose measure names
    the base measure, method, B and the null's fingerprint.  The checkpoint
    hooks (resume_pass, skip_passes, covered, rebind, pass_complete) pass
    through to the inner sink where it has them.
    """

    def __init__(self, inner: Optional[TileSink] = None,
                 iterations: Optional[int] = None):
        self._inner = inner if inner is not None else DenseSink()
        self._iterations = iterations

    def open(self, plan: ExecutionPlan, device: torch.device) -> None:
        super().open(plan, device)
        b = (self._iterations if self._iterations is not None
             else plan.replicas)
        if b <= 0:
            raise ValueError(
                "ExceedanceSink needs the replica count: open it with a "
                "significance plan (ExecutionPlan.create(replicas=B)) or "
                "pass iterations= explicitly")
        self.iterations = int(b)
        self._inner.open(plan, device)

    def resume_pass(self) -> int:
        return getattr(self._inner, "resume_pass", lambda: 0)()

    def skip_passes(self) -> set:
        return getattr(self._inner, "skip_passes", set)()

    def covered(self):
        return getattr(self._inner, "covered", lambda: None)()

    def rebind(self, new_plan: ExecutionPlan) -> None:
        self.plan = new_plan
        getattr(self._inner, "rebind", lambda _p: None)(new_plan)

    def pass_complete(self, k: int) -> None:
        getattr(self._inner, "pass_complete", lambda _k: None)(k)

    def _pvalues(self, ids: np.ndarray, counts: torch.Tensor) -> torch.Tensor:
        """p-value tiles of one pass's (P, t, t) int32 counts, on their
        device; the division is by a float32 tensor (a host scalar divisor
        becomes a reciprocal multiply on the card)."""
        den = torch.tensor(1.0 + self.iterations, dtype=torch.float32,
                           device=counts.device)
        p = (1.0 + counts.to(torch.float32)) / den
        if self.plan.workload.needs_symmetrize:
            ys, xs = self.plan.workload.job_coord_batch(np.asarray(ids))
            diag = np.nonzero(ys == xs)[0]
            if diag.size:
                sel = torch.as_tensor(diag, device=p.device)
                t = self.plan.t
                upper = torch.ones((t, t), dtype=torch.bool,
                                   device=p.device).triu_()
                d = p[sel]
                p[sel] = torch.where(upper, d, d.transpose(1, 2))
        return p

    def consume(self, ids: np.ndarray, counts: torch.Tensor,
                ready=None) -> None:
        # the p-values queue on the current stream, behind the piece, and
        # the inner sink waits on everything queued (ready None)
        after(ready, counts)
        self._inner.consume(ids, self._pvalues(ids, counts))

    def result(self):
        return self._inner.result()


__all__ = ["PassStream", "after", "TileSink", "DenseSink", "HostSink",
           "ShardedHostSink", "ShardedMatrix", "open_manifest", "assemble",
           "ReductionSink",
           "EdgeCountSink", "RowBlockSink", "TopKSink", "DeviceTopKSink",
           "ExceedanceSink", "place_tiles_host", "scatter_tiles_at",
           "symmetrize", "topk_merge_rows"]
