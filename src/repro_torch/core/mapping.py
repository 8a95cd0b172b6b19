"""Bijective tile-id <-> tile-coordinate mappings (paper SSIII-B).

Port of ``repro/core/mapping.py`` (the host-side, exact-integer part).  For
symmetric all-pairs work only the upper triangle (incl. the diagonal) of the
m x m job matrix is computed.  Jobs are numbered row-major in the triangle:

    J_m(y, x) = F_m(y) + x - y,        0 <= y <= x < m          (Eq. 9)
    F_m(y)    = y * (2m - y + 1) / 2                            (Eq. 10)

and inverted in closed form (Eq. 14/15) with an exact integer repair.  The
CUDA tile kernel (kernels/csrc/pcc_tile.cu) inverts ids with the same
double-sqrt-then-int64-repair scheme as :func:`job_coord_batch`.

Rectangular X-vs-Y work covers the whole m_rows x m_cols tile grid, numbered
row-major (J = y * m_cols + x, inverted by one integer division).

Two banded and lower-triangle families number the (query block, key block)
jobs of causal and sliding-window attention (kernels/flash_attention.py):
the upper band {(y, x): y <= x < min(n, y + w)} in the order of Eq. 9, and
the lower triangle {(y, x): x <= y} and its band {(y, x): max(0, y - w + 1)
<= x <= y} row-major, so that each query row's jobs are consecutive.  All of
them invert with exact integers (``math.isqrt`` and a repair), at any size:
the reference's float32 inverse for its Pallas index maps holds only up to
~2,000 blocks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np


def tri_count(n: int) -> int:
    """Total number of jobs in the upper triangle incl. diagonal: n(n+1)/2."""
    return n * (n + 1) // 2


def f_n(n: int, y: int) -> int:
    """F_n(y): number of upper-triangle cells strictly before row y (Eq. 10)."""
    return y * (2 * n - y + 1) // 2


def job_id(n: int, y: int, x: int) -> int:
    """Job identifier for coordinate (y, x) in the upper triangle (Eq. 9)."""
    if not (0 <= y <= x < n):
        raise ValueError(f"(y={y}, x={x}) not in upper triangle of n={n}")
    return f_n(n, y) + x - y


def job_coord(n: int, j: int) -> Tuple[int, int]:
    """Inverse mapping: job identifier -> (y, x) (Eq. 14/15), exact.

    ``math.isqrt`` keeps it integral at any n: y is the smallest integer
    with F_n(y + 1) > j, i.e. ceil(((2n - 1) - sqrt(disc)) / 2) with the
    radicand scaled by 4, disc = 4n^2 + 4n + 1 - 8(j + 1).
    """
    if not (0 <= j < tri_count(n)):
        raise ValueError(f"job id {j} out of range for n={n}")
    disc = 4 * n * n + 4 * n + 1 - 8 * (j + 1)
    s = math.isqrt(disc)
    y = ((2 * n - 1) - s + 1) // 2
    while f_n(n, y + 1) <= j:
        y += 1
    while f_n(n, y) > j:
        y -= 1
    return y, j + y - f_n(n, y)


def job_coord_batch(n: int, ids) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorised exact inverse mapping: job ids -> (ys, xs), host numpy.

    One float64 sqrt over the batch, then integer clamp loops that repair
    any rounding until s^2 <= disc < (s+1)^2 and F_n(y) <= j < F_n(y+1)
    hold for every element — exact wherever the int64 radicand does not
    overflow, not only where the float64 sqrt is (~2^52).
    """
    j = np.asarray(ids, dtype=np.int64)
    if j.size and (j.min() < 0 or j.max() >= tri_count(n)):
        bad = j[(j < 0) | (j >= tri_count(n))][0]
        raise ValueError(f"job id {bad} out of range for n={n}")
    disc = 4 * n * n + 4 * n + 1 - 8 * (j + 1)
    s = np.floor(np.sqrt(disc.astype(np.float64))).astype(np.int64)
    while np.any(over := s * s > disc):
        s = np.where(over, s - 1, s)
    while np.any(under := (s + 1) * (s + 1) <= disc):
        s = np.where(under, s + 1, s)
    y = ((2 * n - 1) - s + 1) // 2
    y = np.clip(y, 0, n - 1)

    def f(yy):
        return yy * (2 * n - yy + 1) // 2

    while np.any(low := f(y + 1) <= j):
        y = np.where(low, y + 1, y)
    while np.any(high := f(y) > j):
        y = np.where(high, y - 1, y)
    return y, j + y - f(y)


def grid_job_id(rows: int, cols: int, y: int, x: int) -> int:
    """Row-major job id in an r x c rectangular job matrix (Eq. 7 family)."""
    if not (0 <= y < rows and 0 <= x < cols):
        raise ValueError(f"(y={y}, x={x}) outside {rows}x{cols} job matrix")
    return y * cols + x


def grid_job_coord(rows: int, cols: int, j: int) -> Tuple[int, int]:
    """Inverse row-major rectangular mapping (Eq. 8 family)."""
    if not (0 <= j < rows * cols):
        raise ValueError(f"job id {j} out of range for {rows}x{cols}")
    return j // cols, j % cols


def grid_job_coord_batch(rows: int, cols: int, ids) -> Tuple[np.ndarray,
                                                             np.ndarray]:
    """Vectorised exact inverse of the rectangular mapping, host numpy."""
    j = np.asarray(ids, dtype=np.int64)
    if j.size and (j.min() < 0 or j.max() >= rows * cols):
        bad = j[(j < 0) | (j >= rows * cols)][0]
        raise ValueError(f"job id {bad} out of range for {rows}x{cols}")
    return j // cols, j % cols


def band_count(n: int, w: int) -> int:
    """Jobs in the banded upper triangle {(y, x): y <= x < min(n, y + w)}:
    rows 0 .. n - w hold w jobs each, the trailing w - 1 rows a triangle."""
    if w >= n:
        return tri_count(n)
    return (n - w + 1) * w + tri_count(w - 1)


def band_job_id(n: int, w: int, y: int, x: int) -> int:
    """Job id within the banded upper triangle, rows numbered top down."""
    if not (0 <= y <= x < min(n, y + w)):
        raise ValueError(f"(y={y}, x={x}) outside band w={w} of n={n}")
    if w >= n:
        return job_id(n, y, x)
    boundary = n - w + 1          # first row the edge of the matrix truncates
    if y < boundary:
        return y * w + (x - y)
    return boundary * w + f_n(w - 1, y - boundary) + (x - y)


def band_job_coord(n: int, w: int, j: int) -> Tuple[int, int]:
    """Inverse of :func:`band_job_id`, exact."""
    if not (0 <= j < band_count(n, w)):
        raise ValueError(f"job id {j} out of range for band w={w}, n={n}")
    if w >= n:
        return job_coord(n, j)
    boundary = n - w + 1
    head = boundary * w
    if j < head:
        y, dx = divmod(j, w)
        return y, y + dx
    # the tail rows form an upper (w - 1)-triangle
    ty, tx = job_coord(w - 1, j - head)
    return boundary + ty, boundary + tx


def lower_job_id(y: int, x: int) -> int:
    """Row-major id in the lower triangle {(y, x): x <= y}: J = T(y) + x
    with T(y) = y (y + 1) / 2, the transpose-order twin of Eq. 9, so that
    the jobs of one row y are consecutive."""
    if not (0 <= x <= y):
        raise ValueError(f"(y={y}, x={x}) not in lower triangle")
    return tri_count(y) + x


def lower_job_coord(j: int) -> Tuple[int, int]:
    """Exact inverse of :func:`lower_job_id`: y = floor((sqrt(8J + 1) - 1)
    / 2) with an integer square root, then a repair."""
    if j < 0:
        raise ValueError("job id must be non-negative")
    y = (math.isqrt(8 * j + 1) - 1) // 2
    while tri_count(y + 1) <= j:
        y += 1
    while tri_count(y) > j:
        y -= 1
    return y, j - tri_count(y)


def band_lower_count(m: int, w: int) -> int:
    """Jobs in the banded lower triangle {(y, x): max(0, y - w + 1) <= x <=
    y} of an m x m job matrix."""
    if w >= m:
        return tri_count(m)
    return tri_count(w) + (m - w) * w


def band_lower_job_coord(m: int, w: int, j: int) -> Tuple[int, int]:
    """Job id -> (y, x) in the banded lower triangle numbered row-major (the
    first w rows form a triangle, every later row holds w jobs), exact."""
    if not (0 <= j < band_lower_count(m, w)):
        raise ValueError(f"job id {j} out of range for band w={w}, m={m}")
    head = tri_count(min(w, m))
    if j < head:
        return lower_job_coord(j)
    q, r = divmod(j - head, w)
    y = w + q
    return y, (y - w + 1) + r


@dataclasses.dataclass(frozen=True)
class TriangularWorkload:
    """Upper-triangle (incl. diagonal) tile jobs of a symmetric m x m grid."""

    m: int

    needs_symmetrize = True

    @property
    def m_rows(self) -> int:
        return self.m

    @property
    def m_cols(self) -> int:
        return self.m

    @property
    def job_count(self) -> int:
        return tri_count(self.m)

    @property
    def grid_cols(self):
        """Kernel hookup: None selects the triangular tile-id inversion."""
        return None

    def job_coord_batch(self, ids) -> Tuple[np.ndarray, np.ndarray]:
        return job_coord_batch(self.m, ids)


@dataclasses.dataclass(frozen=True)
class GridWorkload:
    """All m_rows x m_cols tile jobs of a rectangular X-vs-Y grid, numbered
    row-major; every cell is computed once, so nothing is mirrored."""

    m_rows: int
    m_cols: int

    needs_symmetrize = False

    @property
    def job_count(self) -> int:
        return self.m_rows * self.m_cols

    @property
    def grid_cols(self) -> int:
        """Kernel hookup: the column count of the grid's tile-id inversion."""
        return self.m_cols

    def job_coord_batch(self, ids) -> Tuple[np.ndarray, np.ndarray]:
        return grid_job_coord_batch(self.m_rows, self.m_cols, ids)


__all__ = ["tri_count", "f_n", "job_id", "job_coord", "job_coord_batch",
           "grid_job_id", "grid_job_coord", "grid_job_coord_batch",
           "band_count", "band_job_id", "band_job_coord", "lower_job_id",
           "lower_job_coord", "band_lower_count", "band_lower_job_coord",
           "TriangularWorkload", "GridWorkload"]
