"""ExecutionPlan: every static decision of an all-pairs run, computed once.

Port of ``repro/core/plan.py``: measure resolution, epilogue fusion, the
stored operand type (``compute_dtype``), padding, the workload (the
symmetric triangle, or the rectangular X-vs-Y grid when ``create`` is
given ``n_cols``), the distribution over p mesh ranks (paper SSIII-D: rank
r owns the contiguous tile ids [r ceil(T/p), (r + 1) ceil(T/p))), the pass
split of each rank's range (paper Alg. 2, C4) and a significance run's
replica axis (``replicas``, ``replica_chunk``) are decided here, host-side
in exact ints; the executor (core/allpairs.py) and the sinks
(core/sinks.py) consume the plan.  Elastic re-partitioning after a device
loss is ``plan.repartition(new_p)`` (runtime/elastic.py): ownership is a
pure function of (total, p, rank), so nothing else in the plan changes.

The defaults t = 256 and l_blk = 512 are the reference's, so tile ids,
launch sizes and :meth:`ExecutionPlan.spec_dict` match its plans key for
key.  The CUDA kernel chooses its own CTA block inside a tile.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import mapping, measures, quantize, tiling
from repro_torch.core.quantize import Operand, operand_data
from repro_torch.kernels.pcc_tile import (DEFAULT_LBLK, DEFAULT_TILE,
                                          EpilogueSpec, dtype_name)

# Default replica-launch width of significance runs (ExecutionPlan.create
# replica_chunk=None): bounds the stacked column operand at 64 x operand, as
# the legacy permutation_pvalues chunk default does.
DEFAULT_REPLICA_CHUNK = 64


def tiles_per_device(total: int, p: int) -> int:
    """ceil(T / p): the uniform per-device (or per-host) tile count (paper
    SSIII-D)."""
    return -(-total // p)


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """All static decisions of one run over p mesh ranks (p = 1: one
    device)."""

    measure: measures.Measure
    tile: tiling.TilePlan
    l_blk: int
    clip: bool
    fused: bool                          # epilogue runs inside the kernel
    epilogue_spec: Optional[EpilogueSpec]
    per_dev: int                         # ceil(total_tiles / p)
    max_tiles_per_pass: int              # per-rank pass bound (C4)
    workload: Union[mapping.TriangularWorkload, mapping.GridWorkload]
    tile_c: Optional[tiling.TilePlan] = None  # column operand (rectangular)
    compute_dtype: Optional[torch.dtype] = None  # stored operand type
    # Significance runs (core/significance.py): null replicas B and the
    # replicas per kernel launch; replicas == 0 is a plain run.
    replicas: int = 0
    replica_chunk: int = 0
    p: int = 1                           # mesh ranks (1: one device)

    @property
    def n(self) -> int:
        return self.tile.n

    @property
    def l(self) -> int:
        return self.tile.l

    @property
    def t(self) -> int:
        return self.tile.t

    @property
    def m(self) -> int:
        return self.tile.m

    @property
    def n_pad(self) -> int:
        return self.tile.n_pad

    @property
    def n_rows(self) -> int:
        return self.tile.n

    @property
    def n_cols(self) -> int:
        """n for the symmetric workload, the second operand's row count for
        the rectangular one."""
        return (self.tile if self.tile_c is None else self.tile_c).n

    @property
    def col_pad(self) -> int:
        return (self.tile if self.tile_c is None else self.tile_c).n_pad

    @functools.cached_property
    def l_pad(self) -> int:
        """Width of the prepared operands: the transform's output width
        (l, or Kendall's C(l, 2) sample pairs) padded to l_blk."""
        width = self.measure.transform(
            torch.zeros((1, self.l)), dtype=torch.float32).shape[1]
        return -(-width // self.l_blk) * self.l_blk

    @property
    def symmetric_problem(self) -> bool:
        """Whether row i and column i of the output are the same variable
        (self-pairs on the diagonal): the triangular workload."""
        return self.workload.needs_symmetrize

    @property
    def total_tiles(self) -> int:
        return self.workload.job_count

    @classmethod
    def create(cls, n: int, l: int, *, n_cols: Optional[int] = None,
               t: int = DEFAULT_TILE, l_blk: int = DEFAULT_LBLK,
               measure: measures.MeasureLike = "pearson", p: int = 1,
               max_tiles_per_pass: Optional[int] = None,
               clip: bool = True,
               fuse_epilogue: bool = True,
               compute_dtype=None, replicas: int = 0,
               replica_chunk: Optional[int] = None) -> "ExecutionPlan":
        """Resolve measure, fusion, operand type, padding, the ranks' tile
        ranges and the pass split.

        p is the number of mesh ranks (launch/mesh.Mesh.size): each owns
        ceil(T / p) consecutive tile ids and splits them into passes of
        at most max_tiles_per_pass.

        n_cols selects the rectangular workload: jobs cover the whole
        ceil(n/t) x ceil(n_cols/t) tile grid of an X-vs-Y product, and the
        executor takes a second operand holding the n_cols variables.
        compute_dtype narrows the stored operands after the float32
        transform: torch.bfloat16 / "bfloat16" or torch.float16 /
        "float16" for any measure; torch.int8 / "int8" stores exact_int8
        measures' values (Kendall's pair signs) as they are and quantizes
        every other measure's rows with absmax scales, as
        torch.float8_e4m3fn / torch.float8_e5m2 do for every measure
        (:func:`needs_row_scales`); torch.int16 / "int16" stores exact_int8
        measures' values only (the kernels take them narrowed to int8,
        :func:`launch_operand`).
        replicas > 0 adds a significance run's replica axis: B null
        replicas, launched replica_chunk (default DEFAULT_REPLICA_CHUNK) at a
        time; Kendall then keeps its sign-GEMM at any l, as in the
        reference.  Without either, kendall / kendall_tau_b at l >= 96 take
        the merge-sort tile kernel (measures.resolve_tile_kernel).
        """
        meas = measures.get(measure)
        cd = resolve_compute_dtype(meas, compute_dtype)
        meas = measures.resolve_tile_kernel(meas, l=l, compute_dtype=cd,
                                            replicas=replicas)
        if meas.tile_kernel is not None:
            if cd is not None:
                raise ValueError(
                    f"measure {meas.name!r} computes on exact fractional "
                    f"ranks; compute_dtype narrowing would corrupt their "
                    f"tie structure (use measure='kendall_sign_gemm' for "
                    f"the int8 sign-GEMM path)")
            if replicas:
                raise ValueError(
                    f"measure {meas.name!r} has no replica mode; "
                    f"significance runs use the sign-GEMM kendall path")
        tile = tiling.TilePlan.create(n, l, t)
        tile_c = (None if n_cols is None
                  else tiling.TilePlan.create(n_cols, l, t))
        if p <= 0:
            raise ValueError(f"p must be positive, got {p}")
        if l_blk <= 0:
            raise ValueError(f"l_blk must be positive, got {l_blk}")
        workload = (mapping.TriangularWorkload(tile.m) if tile_c is None
                    else mapping.GridWorkload(tile.m, tile_c.m))
        spec, fused = measures.resolve_fusion(meas, fuse_epilogue, tile.l,
                                              clip=clip)
        per_dev = tiles_per_device(workload.job_count, p)
        if max_tiles_per_pass is not None and max_tiles_per_pass <= 0:
            raise ValueError(
                f"max_tiles_per_pass must be positive, got {max_tiles_per_pass}")
        mtp = min(per_dev, max_tiles_per_pass or per_dev)
        if replicas < 0:
            raise ValueError(f"replicas must be >= 0, got {replicas}")
        if replica_chunk is not None and replica_chunk <= 0:
            raise ValueError(
                f"replica_chunk must be positive, got {replica_chunk}")
        rc = 0 if replicas == 0 else min(
            replicas, replica_chunk or DEFAULT_REPLICA_CHUNK)
        return cls(measure=meas, tile=tile, l_blk=l_blk, clip=clip,
                   fused=fused, epilogue_spec=spec, per_dev=per_dev,
                   max_tiles_per_pass=mtp, workload=workload, tile_c=tile_c,
                   compute_dtype=cd, replicas=replicas, replica_chunk=rc,
                   p=p)

    @property
    def scaled(self) -> bool:
        """Whether the prepared operands are quantized :class:`Operand`s
        carrying per-row scales."""
        return needs_row_scales(self.measure, self.compute_dtype)

    def _prepare_one(self, x: torch.Tensor):
        return prepare_operand_raw(x, self.measure, self.compute_dtype,
                                   self.t, self.l_blk)

    def prepare(self, x: torch.Tensor):
        """Row-transform x at >= float32, narrow to the compute dtype (the
        stored operand only; the kernel accumulates in float32, or int32
        for int8) and zero-pad to kernel alignment.  Quantizing compute
        dtypes return an :class:`Operand` of padded data and padded
        scales."""
        if tuple(x.shape) != (self.n, self.l):
            raise ValueError(f"x shape {tuple(x.shape)} does not match plan "
                             f"(n={self.n}, l={self.l})")
        return self._prepare_one(x)

    def prepare_pair(self, x: torch.Tensor, y: torch.Tensor) -> Tuple:
        """Rectangular operands: transform x and y independently (the row
        transform is a per-row map) and pad each to kernel alignment."""
        if self.tile_c is None:
            raise ValueError("prepare_pair requires a rectangular plan "
                             "(create(..., n_cols=))")
        if tuple(x.shape) != (self.n_rows, self.l):
            raise ValueError(f"x shape {tuple(x.shape)} does not match plan "
                             f"(n_rows={self.n_rows}, l={self.l})")
        if tuple(y.shape) != (self.n_cols, self.l):
            raise ValueError(f"y shape {tuple(y.shape)} does not match plan "
                             f"(n_cols={self.n_cols}, l={self.l})")
        return self._prepare_one(x), self._prepare_one(y)

    def prepare_rows(self, x):
        """Prepare a row slab of at most ``n_rows`` rows: the serving seam
        (serving/batcher.py).  A plan built for a row count bucketed up to
        a tile multiple serves any probe slab with rows <= n_rows: the slab
        is transformed and narrowed exactly as by :meth:`prepare`, then
        zero-padded to the plan's ``n_pad`` rows.  Zero rows are inert and
        a row's tile values do not depend on the other rows.

        ``x`` may also be a sequence of slabs (the requests of one batch):
        each is transformed on its own, at the shape a standalone
        ``corr(slab, ...)`` transforms, and the prepared rows are stacked.
        On the card a row reduction's order can depend on how many rows
        the tensor holds (PyTorch sizes its reduction blocks by them), so
        this keeps each request's rows bitwise what ``corr`` prepares."""
        slabs = list(x) if isinstance(x, (list, tuple)) else [x]
        for s in slabs:
            if s.ndim != 2 or s.shape[1] != self.l:
                raise ValueError(
                    f"x shape {tuple(s.shape)} does not match plan sample "
                    f"count (l={self.l})")
        rows = sum(s.shape[0] for s in slabs)
        if rows > self.n_rows:
            raise ValueError(
                f"x has {rows} rows, more than the plan's bucketed row "
                f"count {self.n_rows}")
        parts = [self._prepare_one(s) for s in slabs]
        if len(parts) == 1:
            u = parts[0]
            if operand_data(u).shape[0] < self.n_pad:
                u = take_operand_rows(u, slice(0, rows), self.n_pad)
            return u
        datas = [quantize.operand_parts(p)[0][:s.shape[0]]
                 for p, s in zip(parts, slabs)]
        data = F.pad(torch.cat(datas), (0, 0, 0, self.n_pad - rows))
        if not self.scaled:
            return data
        scales = [p.scale[:s.shape[0]] for p, s in zip(parts, slabs)]
        return Operand(data, F.pad(torch.cat(scales), (0, self.n_pad - rows)))

    # -- distribution (paper SSIII-D, C5) ------------------------------------

    def device_range(self, rank: int) -> Tuple[int, int]:
        """Contiguous tile-id range [lo, hi) owned by flat mesh rank
        `rank`."""
        lo = min(rank * self.per_dev, self.total_tiles)
        return lo, min(lo + self.per_dev, self.total_tiles)

    @property
    def device_ranges(self) -> Tuple[Tuple[int, int], ...]:
        return tuple(self.device_range(r) for r in range(self.p))

    def host_tile_range(self, host: int, n_hosts: int) -> Tuple[int, int]:
        """Contiguous tile-id range [lo, hi) whose output host `host` of
        an n_hosts-process run persists (core/sinks.ShardedHostSink).

        n_hosts must divide p: a host keeps the union of its ranks' ranges,
        the reference's forced ownership.  A one-device plan (p == 1, the
        host simulation) splits the tile ids by the ceil partition the
        device split uses."""
        if not 0 <= host < n_hosts:
            raise ValueError(f"host {host} out of range for {n_hosts} hosts")
        if n_hosts == 1:
            return 0, self.total_tiles
        if self.p % n_hosts == 0:
            rph = self.p // n_hosts
            return (self.device_range(host * rph)[0],
                    self.device_range((host + 1) * rph - 1)[1])
        if self.p == 1:
            tph = tiles_per_device(self.total_tiles, n_hosts)
            lo = min(host * tph, self.total_tiles)
            return lo, min(lo + tph, self.total_tiles)
        raise ValueError(
            f"n_hosts={n_hosts} must divide the mesh size p={self.p} "
            f"(each host persists the tiles its local devices compute)")

    def repartition(self, new_p: int) -> "ExecutionPlan":
        """The plan re-sliced for `new_p` ranks (elastic re-meshing): only
        p, per_dev and the pass bound (re-clamped to the new per-rank
        count) change."""
        if new_p <= 0:
            raise ValueError(f"new_p must be positive, got {new_p}")
        per_dev = tiles_per_device(self.total_tiles, new_p)
        return dataclasses.replace(
            self, p=new_p, per_dev=per_dev,
            max_tiles_per_pass=min(self.max_tiles_per_pass, per_dev))

    # -- pass partitioning (paper Alg. 2, C4) --------------------------------

    @property
    def n_pass(self) -> int:
        return -(-self.per_dev // self.max_tiles_per_pass)

    @property
    def launch_sizes(self) -> Tuple[int, ...]:
        """Per-rank launch size of each pass: max_tiles_per_pass, then the
        remainder of the per-rank range."""
        return tiling.pass_launch_sizes(self.per_dev, self.max_tiles_per_pass)

    def pass_offset(self, k: int) -> int:
        """Rank-local tile offset at which pass k starts."""
        return k * self.max_tiles_per_pass

    def rank_slots(self, k: int) -> Tuple[Tuple[int, int], ...]:
        """(start, count) of every rank in pass k: rank r launches the tile
        ids [start, start + count) of its own range, count <= the pass's
        launch size (0 past the end of the workload)."""
        launch, off = self.launch_sizes[k], self.pass_offset(k)
        out = []
        for r in range(self.p):
            lo, hi = self.device_range(r)
            out.append((lo + off, int(np.clip(hi - lo - off, 0, launch))))
        return tuple(out)

    def pass_selection(self, k: int) -> Tuple[np.ndarray,
                                               Optional[np.ndarray]]:
        """``(ids, sel)`` of pass k across the mesh, the reference's: ids
        the valid tile ids in rank order; sel the index of those tiles in
        the reference's (p * launch, t, t) clamped pass output, or None
        when every slot is valid.  The port's executor launches only valid
        slots, so it reads ids alone."""
        launch = self.launch_sizes[k]
        ids, sel = [], []
        for r, (start, count) in enumerate(self.rank_slots(k)):
            ids.append(np.arange(start, start + count, dtype=np.int64))
            sel.append(np.arange(r * launch, r * launch + count,
                                 dtype=np.int64))
        ids = np.concatenate(ids)
        return ids, (None if ids.size == self.p * launch
                     else np.concatenate(sel))

    def pass_ids(self, k: int) -> np.ndarray:
        """The valid tile ids pass k launches, over all ranks."""
        return self.pass_selection(k)[0]

    def pass_padded_ids(self, k: int) -> np.ndarray:
        """The reference's clamped tile id of every slot of pass k's
        (p * launch) output: slot i of rank r holds tile
        min(r per_dev + off + i, total - 1)."""
        launch, off = self.launch_sizes[k], self.pass_offset(k)
        base = (np.arange(self.p, dtype=np.int64)[:, None] * self.per_dev
                + off + np.arange(launch, dtype=np.int64)[None, :])
        return np.minimum(base.reshape(-1), self.total_tiles - 1)

    def coverage_schedule(self, covered: np.ndarray):
        """Resume schedule from a tile-coverage bitmap: ``(k0, skip)``, as
        the reference's ``ExecutionPlan.coverage_schedule``.

        `covered` is a bool bitmap over the tile ids (True: the tile's
        output is already held durably).  k0 is the first pass whose tiles
        are not all covered; `skip` holds the later passes that are, which
        the executor must not launch.  A kill-and-resume leaves a prefix
        (skip empty); a corrupt region dropped from a checkpoint leaves a
        hole, whose pass alone reruns."""
        covered = np.asarray(covered, bool)
        if covered.shape != (self.total_tiles,):
            raise ValueError(
                f"coverage bitmap shape {covered.shape} != "
                f"(total_tiles={self.total_tiles},)")
        full = [bool(covered[self.pass_ids(k)].all())
                for k in range(self.n_pass)]
        k0 = full.index(False) if False in full else self.n_pass
        return k0, {k for k in range(k0 + 1, self.n_pass) if full[k]}

    @property
    def replica_chunk_sizes(self) -> Tuple[int, ...]:
        """Replica-launch sizes of a significance run: replica_chunk, then
        the exact remainder, so no launch computes replicas past
        `replicas`.  Empty for plain runs."""
        if self.replicas == 0:
            return ()
        return tiling.pass_launch_sizes(self.replicas, self.replica_chunk)

    def spec_dict(self) -> dict:
        """JSON-serialisable identity of this plan, key for key the
        reference's ``ExecutionPlan.spec_dict()`` (a custom tile kernel by
        its ``__name__``; ``symmetric_grid``, a mode the port does not
        have, holds False).  replica_chunk
        stays out, as in the reference: p-values do not depend on it."""
        return {
            "n_rows": self.n_rows, "n_cols": self.n_cols, "l": self.l,
            "t": self.t, "l_blk": self.l_blk,
            "measure": self.measure.name,
            "tile_kernel": (None if self.measure.tile_kernel is None
                            else self.measure.tile_kernel.__name__),
            "workload": type(self.workload).__name__,
            "symmetric_grid": False,
            "compute_dtype": (None if self.compute_dtype is None
                              else dtype_name(self.compute_dtype)),
            "clip": self.clip, "fused": self.fused,
            "p": self.p, "max_tiles_per_pass": self.max_tiles_per_pass,
            "total_tiles": self.total_tiles, "n_pass": self.n_pass,
            "replicas": self.replicas,
        }

    def spec_key(self) -> tuple:
        """Hashable form of :meth:`spec_dict`."""
        return tuple(sorted(self.spec_dict().items()))


# compute dtypes the port stores operands in, by the reference's names
_COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
                   "int8": torch.int8, "int16": torch.int16,
                   "float8_e4m3fn": torch.float8_e4m3fn,
                   "float8_e5m2": torch.float8_e5m2}


def resolve_compute_dtype(meas: measures.Measure,
                          compute_dtype) -> Optional[torch.dtype]:
    """The stored operand type of (meas, compute_dtype), or None for the
    transform's float32.

    An fp8 type this torch cannot hold raises ValueError, as the reference
    does: support is probed (:func:`quantize.fp8_supported`), never
    assumed.  int16 stores only an exact_int8 measure's values (Kendall's
    +/-1/0 pair signs); every other measure would need a per-row int16
    quantization scale, which neither package has (the reference fails
    with ``KeyError: 'int16'`` in ``quantize.QMAX``), so it raises
    ValueError here.  Other types are not ported.
    """
    if compute_dtype is None:
        return None
    name = dtype_name(compute_dtype)
    if quantize.is_fp8(name) and not quantize.fp8_supported(name):
        raise ValueError(
            f"compute_dtype={name} is not supported by this torch (probed, "
            f"not assumed: see core/quantize.fp8_supported); use int8 or "
            f"bfloat16")
    if name not in _COMPUTE_DTYPES:
        raise NotImplementedError(
            f"compute_dtype={name} is not ported; the port stores operands "
            f"as {tuple(_COMPUTE_DTYPES)} only (None keeps float32)")
    if name == "int16" and not meas.exact_int8:
        raise ValueError(
            f"compute_dtype=int16 with measure {meas.name!r}: its transform "
            f"is not exactly integer-valued, so storing it as int16 needs a "
            f"per-row quantization scale, and there is no int16 scale "
            f"(quantize.QMAX holds {tuple(quantize.QMAX)}); use int8, or "
            f"int16 on an exact_int8 measure (kendall's pair signs)")
    return _COMPUTE_DTYPES[name]


def needs_row_scales(measure: measures.Measure, compute_dtype) -> bool:
    """Whether (measure, compute_dtype) takes the quantized path (per-row
    absmax scales, dequantized in the kernel) rather than a plain cast:
    every fp8 type, and integer types on measures whose transform is not
    exactly integer-valued.  exact_int8 measures keep their unscaled
    integers."""
    if compute_dtype is None:
        return False
    name = dtype_name(compute_dtype)
    if quantize.is_fp8(name):
        return True
    return name in ("int8", "int16") and not measure.exact_int8


def prepare_operand_raw(x: torch.Tensor, measure: measures.Measure,
                        compute_dtype, t: int, l_blk: int):
    """The one operand-preparation pipeline (the reference's
    ``prepare_operand_raw``): the row transform at float32, then per-row
    quantization (:func:`needs_row_scales`: an :class:`Operand` of padded
    data and padded scales), a cast to the stored type, or float32 kept;
    zero-padded to kernel alignment.  ``ExecutionPlan.prepare*`` and the
    serving layer's CorpusHandle both call it, so a served answer is
    bitwise what ``corr()`` prepares."""
    cd = None if compute_dtype is None else _COMPUTE_DTYPES.get(
        dtype_name(compute_dtype), compute_dtype)
    u = measure.transform(x, dtype=torch.float32)
    if needs_row_scales(measure, cd):
        q, scale = quantize.quantize_rows(u, cd)
        return Operand(pad_operands(q, t, l_blk), pad_scales(scale, t))
    if cd is not None:
        u = u.to(cd)
    return pad_operands(u, t, l_blk)


def take_operand_rows(u, rows, n_pad: int):
    """Rows of a prepared (padded) operand, re-padded with zero rows to
    ``n_pad``: ``rows`` is a slice or an integer index tensor over its rows.
    The delta-plan seam of live corpora (serving/live.py): an append
    launches only the new-vs-old grid and the new-vs-new triangle, both on
    the new rows' prepared slab.  A quantized :class:`Operand` selects and
    pads its data and its scales alike (zero rows, zero scales: inert)."""
    data, scale = quantize.operand_parts(u)
    data = data[rows]
    short = n_pad - data.shape[0]
    if short < 0:
        raise ValueError(
            f"selected {data.shape[0]} rows, more than n_pad={n_pad}")
    data = F.pad(data, (0, 0, 0, short)) if short else data.contiguous()
    if scale is None:
        return data
    scale = scale[rows]
    scale = F.pad(scale, (0, short)) if short else scale.contiguous()
    return Operand(data, scale)


def launch_operand(u):
    """The operand as the tile kernels take it: an int16 operand (an
    exact_int8 measure's +/-1/0 values, the only int16 a plan stores) is
    narrowed to int8, exactly, so it runs the int8 kernels and gives the
    bits of the reference's int32 sums; every other operand is itself."""
    data, scale = quantize.operand_parts(u)
    if data.dtype != torch.int16:
        return u
    return data.to(torch.int8) if scale is None else Operand(
        data.to(torch.int8), scale)


def pad_scales(scale: torch.Tensor, t: int) -> torch.Tensor:
    """Zero-pad per-row scales (n,) to the (n_pad,) row alignment: padding
    rows dequantize to exact zeros."""
    n = scale.shape[0]
    n_pad = -(-n // t) * t
    if n_pad == n:
        return scale.contiguous()
    return F.pad(scale, (0, n_pad - n))


def pad_operands(u: torch.Tensor, t: int, l_blk: int) -> torch.Tensor:
    """Zero-pad transformed variables to (n_pad, l_pad) kernel alignment.
    Zero rows correlate to 0 with everything, so padding is inert."""
    n, l = u.shape
    n_pad = -(-n // t) * t
    l_pad = -(-l // l_blk) * l_blk
    if (n_pad, l_pad) == (n, l):
        return u.contiguous()
    return F.pad(u, (0, l_pad - l, 0, n_pad - n))


__all__ = ["DEFAULT_REPLICA_CHUNK", "ExecutionPlan", "Operand",
           "launch_operand", "needs_row_scales", "pad_operands",
           "pad_scales", "prepare_operand_raw", "resolve_compute_dtype",
           "take_operand_rows", "tiles_per_device"]
