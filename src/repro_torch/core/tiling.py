"""Tiled triangular computation plans (paper SSIII-C, SSIII-D).

Port of ``repro/core/tiling.py``.  The n x n job matrix is cut into t x t
tiles, an m x m tile matrix with m = ceil(n / t), numbered by the same
bijection (core/mapping.py).  Everything here is host-side planning in
Python ints: which tile ids a device owns (C5) and how an id range splits
into memory-bounded passes (C4).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Tuple

from repro_torch.core import mapping


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """Geometry of a tiled symmetric all-pairs computation."""

    n: int          # number of variables (rows of U)
    l: int          # samples per variable (cols of U)
    t: int          # tile side
    m: int          # tiles per side = ceil(n / t)
    n_pad: int      # n rounded up to a multiple of t
    total_tiles: int  # m(m+1)/2

    @classmethod
    def create(cls, n: int, l: int, t: int) -> "TilePlan":
        if n <= 0 or l <= 0 or t <= 0:
            raise ValueError(f"invalid plan n={n} l={l} t={t}")
        m = -(-n // t)
        return cls(n=n, l=l, t=t, m=m, n_pad=m * t,
                   total_tiles=mapping.tri_count(m))


def contiguous_ranges(total: int, p: int) -> List[Tuple[int, int]]:
    """Paper SSIII-D partition: PE i owns [i*ceil(T/p), (i+1)*ceil(T/p)) ∩ [0,T)."""
    if p <= 0:
        raise ValueError("p must be positive")
    chunk = -(-total // p)
    return [(min(total, i * chunk), min(total, (i + 1) * chunk))
            for i in range(p)]


def balanced_counts(total: int, p: int) -> List[Tuple[int, int]]:
    """The remainder spread one tile a PE instead of PE 0..k taking whole
    ceil chunks and the tail PEs nothing: counts differ by at most one.
    Returned as [lo, hi) ranges."""
    if p <= 0:
        raise ValueError("p must be positive")
    base, rem = divmod(total, p)
    out, lo = [], 0
    for i in range(p):
        hi = lo + base + (1 if i < rem else 0)
        out.append((lo, hi))
        lo = hi
    return out


def strided_ids(total: int, p: int, i: int) -> range:
    """Round-robin assignment, Alg. 1's thread-group pattern (J_t = start +
    gid; J_t += numGroups): per-pass counts of the PEs stay within one of
    each other when passes cut the range."""
    return range(i, total, p)


def passes(lo: int, hi: int, max_tiles_per_pass: int) -> Iterator[Tuple[int, int]]:
    """Split [lo, hi) into consecutive passes of at most max_tiles_per_pass
    tiles (paper Alg. 2's J_start/J_end loop)."""
    if max_tiles_per_pass <= 0:
        raise ValueError("max_tiles_per_pass must be positive")
    j = lo
    while j < hi:
        yield (j, min(hi, j + max_tiles_per_pass))
        j = min(hi, j + max_tiles_per_pass)


def pass_launch_sizes(span: int, max_tiles_per_pass: int) -> Tuple[int, ...]:
    """Kernel launch sizes covering a `span`-tile range: full passes of
    max_tiles_per_pass followed by the actual remainder, so the last launch
    computes no dummy tiles."""
    if max_tiles_per_pass <= 0:
        raise ValueError("max_tiles_per_pass must be positive")
    if span <= 0:
        raise ValueError("span must be positive")
    full, rem = divmod(span, max_tiles_per_pass)
    return (max_tiles_per_pass,) * full + ((rem,) if rem else ())


def band_tile_count(m: int, w_tiles: int) -> int:
    """Tiles in the band of width w_tiles of an m x m tile matrix (sliding
    windows; core/mapping.band_count)."""
    return mapping.band_count(m, w_tiles)


def band_tile_coord(m: int, w_tiles: int, jt: int) -> Tuple[int, int]:
    return mapping.band_job_coord(m, w_tiles, jt)


__all__ = ["TilePlan", "contiguous_ranges", "balanced_counts",
           "strided_ids", "passes", "pass_launch_sizes",
           "band_tile_count", "band_tile_coord"]
