"""Merge-sort Kendall tiles (Knight's O(l log l) count): wrapper and plain
version.

Port of ``repro/kernels/kendall_merge.py``.  The sign-GEMM Kendall path
(core/measures.pair_sign_transform) widens the sample axis to all C(l, 2)
sample pairs, so its operand grows as l^2; this path keeps the (n, l) ranks
and computes concordant minus discordant per pair of rows with Knight's
formula

    C - D = n0 - n1 - n2 + n3 - 2 S

n0 = C(l, 2); n1 and n2 the tied sample pairs within the row and within the
column profile (:func:`row_tie_pairs`); n3 the jointly tied pairs; S the
strict inversion count of the column's values after a lexsort of the
samples by (row value, column value).  Every count is an integer (exact in
int32 for l <= 65,536), cast once to float32, so tau-a is bitwise the
sign-GEMM's whenever |C - D| < 2^24.  tau-b multiplies C - D by
``s_i * s_j`` (the product first), s = 1/sqrt(n0 - n_ties) per row and 0
for a constant row; then the fused :class:`EpilogueSpec` runs.

The per-row work, O(n l log l) once per operand, is torch code shared by
the kernel and the plain version (:func:`rank_structure`): each row's
stable order by value, the run index of each sorted position, each value's
dense rank (its code), kept as int16 rows where the kernel takes l, the
row's tie pairs and longest tie run, and for tau-b its scale
(:func:`tau_b_scale`).
It is made once per operand and kept beside it while the operand lives
unchanged, so the passes of a run share it.  The kernel and the plain
version start from the same integers and scales, and tau-b agrees bitwise
by construction, on the card and on the CPU alike.  The per-pair
O(l log l) count is the kernel's (kernels/csrc/kendall_merge.cu): for
pair (i, j) it lays the column's codes q out in row i's order; the lexsort
only reorders q inside row i's tie runs, so S = inv(q) - I_w with I_w the
inversions of q inside those runs, and n3 the equal q inside them.  A row
whose longest run is at most :data:`SHORT_RUN_MAX` takes I_w and n3 by
direct compares and sorts q once; a row with a longer run sorts the
lexsort's keys first, then q.  Each sort: a group of P threads, E keys a
thread (P E >= l, the smallest of the kernel's instantiations that
covers l), sorted in registers, then merge-path levels in shared memory;
a warp a pair at l <= 1,024.  The plain version keeps the reference's
arithmetic: the lexsort and merge levels over the next power of two, tail
padded with sentinels.

Dispatch is by the operand's device: a CUDA tensor launches the kernel or
raises; a CPU tensor runs :func:`kendall_merge_tiles_plain`.  The kernel
keeps codes, order and runs as uint16, so it takes l <=
:data:`MAX_KERNEL_L`; above that it raises ValueError (the plain version
has no such limit).
"""

from __future__ import annotations

import ctypes
import dataclasses
import weakref
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.mapping import grid_job_coord_batch, job_coord_batch
from repro_torch.kernels.pcc_tile import (DEFAULT_LBLK, DEFAULT_TILE,
                                          EpilogueSpec)

# The reference's sample count at and above which plan creation swaps
# kendall / kendall_tau_b for the merge-sort variants
# (core/measures.resolve_tile_kernel).
KENDALL_MERGE_CROSSOVER_L = 96
# The kernel keeps codes, order and run indices as uint16 (values < l) and,
# at l = 16,384 with uint32 keys, 202,784 bytes of shared memory, under the
# 232,448 a block may take (csrc/kendall_merge.cu MAX_L).
MAX_KERNEL_L = 16_384
# The longest tie run of a row whose I_w and n3 the kernel takes by direct
# compares (one sort a pair); a row with a longer run sorts twice
# (csrc/kendall_merge.cu SHORT_RUN_MAX).
SHORT_RUN_MAX = 32
# Bytes one chunk of the plain version's (rows, cols, l_p2) int64 keys may
# take.
PLAIN_CHUNK_BYTES = 1 << 28


def _run_offsets(new_run: torch.Tensor) -> torch.Tensor:
    """Each element's offset into its maximal run (idx - run_start, by a
    cummax of run-start indices), given the new-run mask (..., l) of sorted
    sequences."""
    l = new_run.shape[-1]
    idx = torch.arange(l, device=new_run.device)
    return idx - torch.cummax(torch.where(new_run, idx, 0), dim=-1).values


def _run_pair_count(new_run: torch.Tensor) -> torch.Tensor:
    """Sum of C(c, 2) over the maximal runs of each sorted sequence, given
    its new-run mask (..., l): the offsets into the runs telescope to the
    per-run pair counts.  int32."""
    return _run_offsets(new_run).sum(-1).to(torch.int32)


def _new_runs(s: torch.Tensor) -> torch.Tensor:
    """New-run mask of sorted sequences (..., l): True where a value
    differs from its predecessor, and at the first position."""
    new = torch.ones_like(s, dtype=torch.bool)
    new[..., 1:] = s[..., 1:] != s[..., :-1]
    return new


def narrow_stride(l: int) -> int:
    """Row stride of the kernel's int16 structures: l rounded up to 8, so
    every row starts 16-byte aligned for cp.async."""
    return -(-l // 8) * 8


def row_tie_pairs(u: torch.Tensor) -> torch.Tensor:
    """Per-row tie-pair counts of an (n, l) rank operand: sum of C(c, 2)
    over each row's runs of equal values (Knight's n1 / n2).  int32 (n,)."""
    return _run_pair_count(_new_runs(torch.sort(u, dim=1).values))


@dataclasses.dataclass(frozen=True)
class RankStructure:
    """What the per-pair count needs of each row of an (n, l) operand:
    ``order`` its stable argsort, ``runs`` the run index of each sorted
    position (0, 1, ... : equal values share one), ``codes`` each value's
    dense rank (order and ties kept, in [0, l)); one copy each, the one the
    kernel reads where it takes l (l <= MAX_KERNEL_L: int16 rows of stride
    :func:`narrow_stride`, zero tail), else int32 (n, l); their first l
    columns are the data.  ``ties`` its tie pairs and ``longest`` its
    longest tie run (n,) int32; ``wide``: some non-constant row's longest
    run exceeds SHORT_RUN_MAX (the kernel's uint32 keys)."""

    order: torch.Tensor
    runs: torch.Tensor
    codes: torch.Tensor
    ties: torch.Tensor
    longest: torch.Tensor
    wide: bool


def _narrow_rows(x: torch.Tensor) -> torch.Tensor:
    """int16 copy of the (n, l) rows x, padded with zeros to the stride."""
    l = x.shape[1]
    return F.pad(x.to(torch.int16), (0, narrow_stride(l) - l)).contiguous()


def rank_structure(u_l: torch.Tensor) -> RankStructure:
    """The :class:`RankStructure` of the float32 rows u_l (n, l)."""
    s, order = torch.sort(u_l, dim=1, stable=True)
    new = _new_runs(s)
    runs = torch.cumsum(new, dim=1) - 1
    codes = torch.empty_like(runs).scatter_(1, order, runs)
    l = u_l.shape[1]
    offsets = _run_offsets(new)
    ties = offsets.sum(-1).to(torch.int32)
    longest = (offsets.amax(-1) + 1).to(torch.int32)
    # a constant row skips the count, whatever its run
    wide = bool(((longest > SHORT_RUN_MAX)
                 & (ties < l * (l - 1) // 2)).any())
    keep = (_narrow_rows if l <= MAX_KERNEL_L
            else lambda x: x.to(torch.int32).contiguous())
    return RankStructure(keep(order), keep(runs), keep(codes), ties,
                         longest, wide)


def tau_b_scale(ties: torch.Tensor, l: int) -> torch.Tensor:
    """Per-row tau-b factors: 1/sqrt(n0 - n_ties), 0 for a constant row
    (the reference's formula; float32, on the ties' device).  Computed on
    the host in numpy, whose float32 sqrt and division are correctly
    rounded, so that a run gives the same bits on the card and on the CPU:
    torch's vectorised CPU sqrt is not correctly rounded (sqrt(267) gives
    16.340134, the nearer float is 16.340136), while the card's is."""
    nz = (l * (l - 1) // 2
          - ties.cpu().numpy().astype(np.int64)).astype(np.float32)
    s = np.where(nz > 0, np.float32(1.0) / np.sqrt(np.maximum(nz, 1.0)),
                 np.float32(0.0)).astype(np.float32)
    return torch.from_numpy(s).to(ties.device)


def _check(u_pad, j_start: int, t: int, pass_tiles: int, v_pad, grid_cols,
           l: int) -> Tuple[int, int, torch.Tensor]:
    """The reference's validation; returns (m, total, column operand)."""
    if not isinstance(u_pad, torch.Tensor) or u_pad.ndim != 2:
        raise ValueError("u_pad must be a 2-D torch tensor")
    if u_pad.device.type not in ("cuda", "cpu"):
        raise ValueError(f"u_pad on unsupported device {u_pad.device}")
    n_pad, l_pad = u_pad.shape
    if t <= 0 or n_pad == 0 or n_pad % t or l > l_pad:
        raise ValueError(f"u_pad {tuple(u_pad.shape)} not aligned to t={t} "
                         f"/ l={l}")
    if l < 2:
        raise ValueError(f"kendall needs at least 2 samples, got l={l}")
    if pass_tiles <= 0:
        raise ValueError(f"pass_tiles must be positive, got {pass_tiles}")
    if j_start < 0:
        raise ValueError(f"j_start must be non-negative, got {j_start}")
    if v_pad is not None and (not isinstance(v_pad, torch.Tensor)
                              or v_pad.ndim != 2):
        raise ValueError("the merge-sort kendall kernel has no replica "
                         "mode: significance runs use the sign-GEMM path")
    if v_pad is not None and grid_cols is None and \
            v_pad.shape != u_pad.shape:
        raise ValueError(
            f"a 2-D second operand may ride the triangular bijection only "
            f"when it matches u_pad exactly, got v_pad {tuple(v_pad.shape)}")
    v = u_pad if v_pad is None else v_pad
    if v.device != u_pad.device or v.shape[1] < l:
        raise ValueError(f"v_pad {tuple(v.shape)} on {v.device} does not "
                         f"hold l={l} samples on {u_pad.device}")
    if grid_cols is not None and v.shape[0] != grid_cols * t:
        raise ValueError(
            f"column operand {tuple(v.shape)} does not match grid_cols="
            f"{grid_cols} tiles of t={t}")
    m = n_pad // t
    total = m * (m + 1) // 2 if grid_cols is None else m * grid_cols
    return m, total, v


# id(operand) -> (weak reference to it, (its version, l, tau_b), its rank
# structure, its tau-b scales or None); an entry goes with its operand.
_STRUCTURES: Dict[int, tuple] = {}


def _structure_of(op: torch.Tensor, l: int, tau_b: bool):
    """The rank structure of the operand's first l samples, and its tau-b
    scales (None for tau-a): made once per operand and reused while the
    operand lives and is not written in place (its version counter)."""
    key = id(op)
    stamp = None if op.is_inference() else (op._version, l, tau_b)
    hit = _STRUCTURES.get(key)
    if stamp is not None and hit is not None and hit[0]() is op \
            and hit[1] == stamp:
        return hit[2], hit[3]
    st = rank_structure(op[:, :l].to(torch.float32))
    scale = tau_b_scale(st.ties, l) if tau_b else None
    if stamp is not None:
        _STRUCTURES[key] = (weakref.ref(op, lambda _, k=key:
                                        _STRUCTURES.pop(k, None)),
                            stamp, st, scale)
    return st, scale


def _structures(u_pad: torch.Tensor, v: torch.Tensor, l: int, tau_b: bool):
    """(rows, cols, row scales, column scales): the row operand's and the
    column operand's rank structures and tau-b scales (one of each when
    the columns are the rows)."""
    rows, s_r = _structure_of(u_pad, l, tau_b)
    cols, s_c = (rows, s_r) if v is u_pad else _structure_of(v, l, tau_b)
    return rows, cols, s_r, s_c


def kendall_merge_tiles(u_pad: torch.Tensor, j_start: int, *,
                        t: int = DEFAULT_TILE, l_blk: int = DEFAULT_LBLK,
                        pass_tiles: int,
                        epilogue: Optional[EpilogueSpec] = None,
                        v_pad: Optional[torch.Tensor] = None,
                        grid_cols: Optional[int] = None, l: int,
                        tau_b: bool = False) -> torch.Tensor:
    """Compute `pass_tiles` consecutive Kendall tiles from tile id
    `j_start`: the merge-sort counterpart of ``pcc_tiles``.

    u_pad: (n_pad, l_pad) fractional-rank operand
           (measures.kendall_rank_transform), zero-padded; the first `l`
           samples are the data (zero-padding a row would change its tie
           structure, so they are sliced back out).
    l:     the true sample count.
    tau_b: scale each C - D by s_i * s_j (tau-b); False keeps raw C - D
           (tau-a, whose epilogue divides by C(l, 2)).
    epilogue / v_pad / grid_cols: as ``pcc_tiles``; a triangle's v_pad
           must match u_pad's shape; no replica stacks.  Ids past the end
           clamp to the last tile; l_blk is accepted for the shared launch
           signature and unused.
    Returns (pass_tiles, t, t) float32.  ``kendall_merge_tiles.launches``
    counts the CUDA kernel's launches, ``.launches_by_mode`` per tau_a /
    tau_b.
    """
    del l_blk
    j_start = int(j_start)
    m, _, v = _check(u_pad, j_start, t, pass_tiles, v_pad, grid_cols, l)
    if u_pad.device.type == "cpu":
        return kendall_merge_tiles_plain(
            u_pad, j_start, t=t, pass_tiles=pass_tiles, epilogue=epilogue,
            v_pad=v_pad, grid_cols=grid_cols, l=l, tau_b=tau_b)
    if l > MAX_KERNEL_L:
        raise ValueError(
            f"the kendall_merge kernel takes l <= {MAX_KERNEL_L} samples "
            f"(uint16 codes and its shared memory), got l={l}")
    from repro_torch.kernels import _build

    rows, cols, s_r, s_c = _structures(u_pad, v, l, tau_b)
    lib = _build.load("kendall_merge")
    spec = epilogue if epilogue is not None else EpilogueSpec()
    out = torch.empty((pass_tiles, t, t), dtype=torch.float32,
                      device=u_pad.device)

    def ptr(x):
        return ctypes.c_void_p(0 if x is None else x.data_ptr())

    with torch.cuda.device(u_pad.device):
        stream = torch.cuda.current_stream(u_pad.device).cuda_stream
        err = lib.kendall_merge_tiles_launch(
            ptr(rows.order), ptr(rows.runs), ptr(rows.longest),
            ptr(rows.ties), ptr(s_r), ptr(cols.codes), ptr(cols.ties),
            ptr(s_c), ptr(out), j_start, pass_tiles, m, grid_cols or 0, t, l,
            narrow_stride(l), int(tau_b), int(rows.wide), int(cols is rows),
            *spec.kernel_args(), ctypes.c_void_p(stream))
    if err != 0:
        msg = lib.kendall_merge_error_string(err).decode()
        raise RuntimeError(f"kendall_merge_tiles launch failed: {msg}")
    kendall_merge_tiles.launches += 1
    kendall_merge_tiles.launches_by_mode["tau_b" if tau_b else "tau_a"] += 1
    return out


kendall_merge_tiles.launches = 0
kendall_merge_tiles.launches_by_mode = {"tau_a": 0, "tau_b": 0}


def _inversions(ys: torch.Tensor, l: int, sentinel: int) -> torch.Tensor:
    """Strict inversion counts of the sequences ys (..., l) (pairs a < b
    with ys[a] > ys[b]) by the reference's explicit merge levels over the
    next power of two, tail padded with `sentinel` (larger than every
    value: padding only ever meets all-sentinel right blocks).  int64."""
    lp2 = 1 << (l - 1).bit_length()
    a = F.pad(ys, (0, lp2 - l), value=sentinel)
    inv = torch.zeros(ys.shape[:-1], dtype=torch.int64, device=ys.device)
    blk = 1
    while blk < lp2:
        pairs = a.reshape(*a.shape[:-1], lp2 // (2 * blk), 2 * blk)
        left = pairs[..., :blk].contiguous()
        right = pairs[..., blk:].contiguous()
        # both halves sorted (loop invariant): count the left elements
        # strictly greater than each right element
        cnt = blk - torch.searchsorted(left, right, right=True)
        inv += cnt.sum(dim=(-1, -2))
        a = torch.sort(pairs, dim=-1).values.reshape(a.shape)
        blk *= 2
    return inv


def _pair_terms(rows: RankStructure, cols: RankStructure,
                     ri: torch.Tensor, ci: torch.Tensor, l: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Knight's (n3, S) for every pair of rows `ri` (R,) of `rows` and
    columns `ci` (C,) of `cols`: the column's codes gathered in the row's
    order, sorted by (row run, code) (the lexsort by (x, y)), n3 from the
    runs of equal keys and S by merge levels.  int64 (R, C)."""
    order = rows.order[ri, :l].long()
    runs = rows.runs[ri, :l].long()
    codes = cols.codes[ci, :l].long()
    n_r, n_c = order.shape[0], codes.shape[0]
    q = torch.gather(codes[None].expand(n_r, n_c, l), 2,
                     order[:, None, :].expand(n_r, n_c, l))
    key = torch.sort(runs[:, None, :] * l + q, dim=-1).values
    n3 = _run_pair_count(_new_runs(key)).long()
    s = _inversions(key % l, l, sentinel=l)
    return n3, s


def kendall_merge_tiles_plain(u_pad: torch.Tensor, j_start: int, *,
                              t: int = DEFAULT_TILE,
                              l_blk: int = DEFAULT_LBLK, pass_tiles: int,
                              epilogue: Optional[EpilogueSpec] = None,
                              v_pad: Optional[torch.Tensor] = None,
                              grid_cols: Optional[int] = None, l: int,
                              tau_b: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`kendall_merge_tiles`, on any device:
    the same rank structures, then per tile Knight's terms of each
    (row, column) pair (:func:`_pair_terms`), in chunks of tile rows
    so that one chunk's keys stay within PLAIN_CHUNK_BYTES; C - D in int32,
    cast once to float32, tau-b's scale product, the epilogue."""
    del l_blk
    j_start = int(j_start)
    m, total, v = _check(u_pad, j_start, t, pass_tiles, v_pad, grid_cols, l)
    rows, cols, s_r, s_c = _structures(u_pad, v, l, tau_b)
    ids = np.minimum(j_start + np.arange(pass_tiles, dtype=np.int64),
                     total - 1)
    ys, xs = (job_coord_batch(m, ids) if grid_cols is None
              else grid_job_coord_batch(m, grid_cols, ids))
    dev = u_pad.device
    n0 = l * (l - 1) // 2
    lp2 = 1 << (l - 1).bit_length()
    chunk = max(1, PLAIN_CHUNK_BYTES // (t * lp2 * 8))
    out = torch.empty((pass_tiles, t, t), dtype=torch.float32, device=dev)
    for k, (y, x) in enumerate(zip(ys.tolist(), xs.tolist())):
        ci = torch.arange(x * t, (x + 1) * t, device=dev)
        for r0 in range(0, t, chunk):
            ri = torch.arange(y * t + r0, y * t + min(t, r0 + chunk),
                              device=dev)
            n3, s = _pair_terms(rows, cols, ri, ci, l)
            cmd = (n0 - rows.ties[ri, None].long() - cols.ties[None, ci].long()
                   + n3 - 2 * s).to(torch.int32).to(torch.float32)
            if tau_b:
                cmd = cmd * (s_r[ri, None] * s_c[None, ci])
            out[k, r0:r0 + ri.shape[0]] = cmd
    if epilogue is not None and not epilogue.is_identity():
        out = epilogue.apply(out)
    return out


def kendall_merge_tile_kernel(u_pad, j_start, **kw):
    """tau-a merge-sort tile kernel (``Measure.tile_kernel`` entry point)."""
    return kendall_merge_tiles(u_pad, j_start, tau_b=False, **kw)


def kendall_tau_b_merge_tile_kernel(u_pad, j_start, **kw):
    """tau-b merge-sort tile kernel (``Measure.tile_kernel`` entry point)."""
    return kendall_merge_tiles(u_pad, j_start, tau_b=True, **kw)


# The executor's seam for state kept beside an operand: over a mesh
# (core/allpairs._launches) the rank structures are made on each
# device's current stream before the ranks' streams, which share them,
# launch.
kendall_merge_tile_kernel.prepare_operands = \
    lambda u, v, l: _structures(u, u if v is None else v, l, False)
kendall_tau_b_merge_tile_kernel.prepare_operands = \
    lambda u, v, l: _structures(u, u if v is None else v, l, True)


__all__ = ["KENDALL_MERGE_CROSSOVER_L", "MAX_KERNEL_L", "RankStructure",
           "SHORT_RUN_MAX", "kendall_merge_tile_kernel",
           "kendall_merge_tiles", "kendall_merge_tiles_plain",
           "kendall_tau_b_merge_tile_kernel", "narrow_stride",
           "rank_structure", "row_tie_pairs", "tau_b_scale"]
