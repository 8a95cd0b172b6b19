"""Pluggable similarity measures for the tiled all-pairs engine.

Port of ``repro/core/measures.py``.  A measure is a row transform plus an
elementwise epilogue around the shared tile kernel:

    S(X_i, X_j) = epilogue(<row_transform(X)_i, row_transform(X)_j>, l)

  measure        row_transform (X -> U)                 epilogue(v, l)  clip
  -------------  -------------------------------------  --------------  ------
  pearson        center + L2-normalise (Eq. 4)          identity        [-1,1]
  spearman       average-tie rank, then Eq. 4           identity        [-1,1]
  cosine         L2-normalise only                      identity        [-1,1]
  covariance     center only                            v / (l - 1)     none
  kendall        sign(X[a] - X[b]) over pairs a < b     v / C(l, 2)     [-1,1]
  kendall_tau_b  pair signs scaled per row by           identity        [-1,1]
                 1/sqrt(#non-tied pairs)
  kendall_merge  fractional ranks; Knight's count in    v / C(l, 2)     [-1,1]
                 the tile kernel
  kendall_tau_b_merge  the same, tau-b scales in it     identity        [-1,1]
  dot            identity                               identity        none

Kendall's pair-sign rows are exactly +/-1/0 (``exact_int8``), so they may
be stored as int8 operands.  The pair-sign operand grows as l^2, so from
l = KENDALL_MERGE_CROSSOVER_L (96) on, without a compute_dtype or a
replica axis, :func:`resolve_tile_kernel` swaps kendall / kendall_tau_b
for their merge-sort variants (``kendall_merge``, ``kendall_tau_b_merge``):
the operand is the (n, l) ranks and a custom tile kernel
(kernels/kendall_merge.py) counts C - D per pair in O(l log l), tau-a
bitwise the sign-GEMM's.  Pearson, cosine and covariance also have
pairwise-complete variants for missing data (:class:`MaskedMeasure`,
``corr(..., where=)``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import pcc
from repro_torch.kernels.kendall_merge import (
    KENDALL_MERGE_CROSSOVER_L, kendall_merge_tile_kernel,
    kendall_tau_b_merge_tile_kernel)
from repro_torch.kernels.pcc_tile import EpilogueSpec


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


def _check_2d(x: torch.Tensor) -> None:
    if x.ndim != 2:
        raise ValueError(f"expected (n, l) matrix, got shape {tuple(x.shape)}")


# -- row transforms -------------------------------------------------------------


def rank_rows(x: torch.Tensor) -> torch.Tensor:
    """Average-tie (fractional) ranks of each row, 1-based, float.

    One sort plus two binary searches per row: rank(v) = (#less +
    #less_or_equal + 1) / 2, so ties get the mean of the ranks they span
    (scipy.stats.rankdata's convention), bitwise as in the reference.
    """
    _check_2d(x)
    xa = x.to(_acc_dtype(x))
    s = torch.sort(xa, dim=1).values
    lo = torch.searchsorted(s, xa, side="left")
    hi = torch.searchsorted(s, xa, side="right")
    return 0.5 * (lo + hi + 1).to(xa.dtype)


def spearman_transform(x: torch.Tensor, *, dtype=None) -> torch.Tensor:
    """Spearman(X) == Pearson(rank(X)): rank each row, then Eq. 4."""
    return pcc.transform(rank_rows(x), dtype=dtype or x.dtype)


def l2_normalize_rows(x: torch.Tensor, *, dtype=None) -> torch.Tensor:
    """U_i = X_i / ||X_i||_2 (cosine); all-zero rows map to zeros."""
    _check_2d(x)
    xa = x.to(_acc_dtype(x))
    norm = torch.sqrt((xa * xa).sum(dim=1, keepdim=True))
    u = torch.where(norm > 0, xa / torch.where(norm > 0, norm, 1.0), 0.0)
    return u.to(dtype or x.dtype)


def center_rows(x: torch.Tensor, *, dtype=None) -> torch.Tensor:
    """U_i = X_i - mean(X_i): <U_i, U_j> / (l - 1) is the covariance."""
    _check_2d(x)
    xa = x.to(_acc_dtype(x))
    return (xa - xa.mean(dim=1, keepdim=True)).to(dtype or x.dtype)


def pair_sign_transform(x: torch.Tensor, *, dtype=None) -> torch.Tensor:
    """Kendall tau-a row transform: sign(X[a] - X[b]) over all C(l, 2)
    sample pairs a < b, in ``np.triu_indices(l, 1)`` order.

    <U_i, U_j> counts concordant minus discordant pairs, so tau-a is
    <U_i, U_j> / C(l, 2).  The output is (n, l(l-1)/2): small l only.
    """
    _check_2d(x)
    l = x.shape[1]
    if l < 2:
        raise ValueError(f"kendall needs at least 2 samples, got l={l}")
    ia, ib = torch.triu_indices(l, l, 1, device=x.device)
    xa = x.to(_acc_dtype(x))
    return torch.sign(xa[:, ia] - xa[:, ib]).to(dtype or x.dtype)


def kendall_rank_transform(x: torch.Tensor, *, dtype=None) -> torch.Tensor:
    """Merge-sort Kendall row transform: the fractional ranks, (n, l).  The
    tile kernel (kernels/kendall_merge.py) counts C - D from them directly,
    so the pair axis never materialises; ranks keep each row's order and
    tie structure, which is all Kendall depends on."""
    return rank_rows(x).to(dtype or _acc_dtype(x))


def pair_sign_tie_scaled_transform(x: torch.Tensor, *,
                                   dtype=None) -> torch.Tensor:
    """Kendall tau-b row transform: pair signs scaled per row by
    1/sqrt(n0 - n1_i), row i's count of non-zero signs, so the plain inner
    product is tau-b.  Fully tied rows map to zero rows (score 0)."""
    s = pair_sign_transform(x, dtype=torch.float32)
    nz = (s != 0.0).sum(dim=1).to(torch.float32)
    scale = torch.where(nz > 0, 1.0 / torch.sqrt(torch.clamp(nz, min=1.0)),
                        0.0)
    return (s * scale[:, None]).to(dtype or x.dtype)


def identity_transform(x: torch.Tensor, *, dtype=None) -> torch.Tensor:
    """Pass-through row transform: the kernel computes raw inner products
    (the "dot" measure)."""
    _check_2d(x)
    return x.to(dtype or x.dtype)


# -- moment-form transforms (live corpora, serving/live.py) ----------------------
# A transform whose only per-row statistics are the row mean and the
# centered sum of squares M2 = sum((x - mean)^2) rebuilds any single row's
# output from (raw row, mean, M2): append / update of d rows of a live
# corpus then costs O(d l) instead of a full re-transform.  The rank
# transforms (spearman, kendall*) have none.  The arithmetic follows the
# full transforms (the same centering, the same zero-row convention), so a
# freshly seeded row of pearson or covariance is bitwise its cold
# transform; rows maintained through delta merges carry the float drift a
# live corpus's drift budget bounds.


def pearson_from_moments(x: torch.Tensor, mean: torch.Tensor,
                         m2: torch.Tensor, l: int, *,
                         dtype=None) -> torch.Tensor:
    """Eq. 4 from per-row moments: U_i = (X_i - mean_i) / sqrt(M2_i), rows
    with sqrt(M2_i) == 0 mapped to zeros (pcc.transform's convention)."""
    acc = _acc_dtype(x)
    xa = x.to(acc)
    norm = torch.sqrt(torch.clamp(m2.to(acc), min=0.0))[:, None]
    centered = xa - mean.to(acc)[:, None]
    live = norm > 0
    u = torch.where(live, centered / torch.where(live, norm, 1.0), 0.0)
    return u.to(dtype or x.dtype)


def cosine_from_moments(x: torch.Tensor, mean: torch.Tensor,
                        m2: torch.Tensor, l: int, *,
                        dtype=None) -> torch.Tensor:
    """L2 normalisation from moments: ||X_i||^2 = M2_i + l mean_i^2."""
    acc = _acc_dtype(x)
    xa = x.to(acc)
    mu = mean.to(acc)
    sumsq = m2.to(acc) + l * (mu * mu)
    norm = torch.sqrt(torch.clamp(sumsq, min=0.0))[:, None]
    u = torch.where(norm > 0, xa / torch.where(norm > 0, norm, 1.0), 0.0)
    return u.to(dtype or x.dtype)


def covariance_from_moments(x: torch.Tensor, mean: torch.Tensor,
                            m2: torch.Tensor, l: int, *,
                            dtype=None) -> torch.Tensor:
    """Centering from moments: U_i = X_i - mean_i (M2 unused)."""
    acc = _acc_dtype(x)
    return (x.to(acc) - mean.to(acc)[:, None]).to(dtype or x.dtype)


def dot_from_moments(x: torch.Tensor, mean: torch.Tensor, m2: torch.Tensor,
                     l: int, *, dtype=None) -> torch.Tensor:
    """Identity (the dot measure has no per-row statistics)."""
    return x.to(dtype or x.dtype)


# -- epilogues ------------------------------------------------------------------
# Built-in epilogues are static divisions; fused (EpilogueSpec in the kernel)
# and unfused (EpilogueSpec.apply on the pass stream) share one reciprocal
# multiply, so both give the same bits.


def _cov_div(l: int) -> float:
    return float(max(l - 1, 1))


def _kendall_div(l: int) -> float:
    return float(max(l * (l - 1) // 2, 1))


def _cov_epilogue(vals: torch.Tensor, l: int) -> torch.Tensor:
    return EpilogueSpec(div=_cov_div(l)).apply(vals)


def _kendall_epilogue(vals: torch.Tensor, l: int) -> torch.Tensor:
    return EpilogueSpec(div=_kendall_div(l)).apply(vals)


# -- the Measure record ---------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Measure:
    """A symmetric pairwise similarity decomposed for the tiled engine.

    transform:    (n, l) -> (n, l') row map; the kernel computes U U^T tiles.
    epilogue:     elementwise map (raw_value, original_l) -> similarity, or
                  None for identity.
    clip:         output range enforced when the caller asks for clipping,
                  or None.
    epilogue_div: static denominator given l, for epilogues v -> v / div —
                  the kernel-inlinable description of `epilogue`.  When set
                  (or when epilogue is None) the measure is fusable.
    exact_int8:   the transform's output is exactly representable in int8
                  (Kendall's pair signs), which allows int8 operands.
    permute_gather: the transform commutes with sample permutation, so a
                  significance run builds its permutation replicas by
                  gathering columns of the prepared operand
                  (core/significance.replica_operand).
    tile_kernel:  None rides the shared tile kernel; a callable with the
                  launch signature of ``pcc_tiles`` plus the true sample
                  count ``l`` replaces it (the merge-sort Kendall kernels,
                  kernels/kendall_merge.py).
    from_moments: ``(x_rows, mean, m2, l, dtype=)`` rebuilds transformed
                  rows from raw rows and their running moments: the
                  incremental seam of live corpora (serving/live.py).
                  None: the transform has no moment form (rank measures),
                  so a mutated corpus re-transforms exactly.
    """

    name: str
    transform: Callable[..., torch.Tensor]
    epilogue: Optional[Callable[[torch.Tensor, int], torch.Tensor]] = None
    clip: Optional[Tuple[float, float]] = None
    epilogue_div: Optional[Callable[[int], float]] = None
    exact_int8: bool = False
    permute_gather: bool = False
    tile_kernel: Optional[Callable[..., torch.Tensor]] = None
    from_moments: Optional[Callable[..., torch.Tensor]] = None

    @property
    def incremental(self) -> bool:
        """Whether a live corpus can maintain this measure's prepared
        operand from running per-row moments (O(delta l) append / update)."""
        return self.from_moments is not None and self.tile_kernel is None

    @property
    def fusable(self) -> bool:
        """Whether the epilogue can be inlined into the kernel."""
        return self.epilogue is None or self.epilogue_div is not None

    def fused_spec(self, l: int, *, clip: bool = True) -> Optional[EpilogueSpec]:
        """The kernel-fused form of finalize() for sample count l, or None
        for non-fusable epilogues."""
        if not self.fusable:
            return None
        return EpilogueSpec(
            div=self.epilogue_div(l) if self.epilogue_div is not None else None,
            clip=self.clip if clip else None)

    def finalize(self, vals: torch.Tensor, l: int, *,
                 clip: bool = True) -> torch.Tensor:
        """Apply the epilogue (and optional clip) to raw kernel output."""
        if self.epilogue is not None:
            vals = self.epilogue(vals, l)
        if clip and self.clip is not None:
            vals = torch.clamp(vals, *self.clip)
        return vals


PEARSON = Measure("pearson", pcc.transform, None, (-1.0, 1.0),
                  permute_gather=True, from_moments=pearson_from_moments)
SPEARMAN = Measure("spearman", spearman_transform, None, (-1.0, 1.0),
                   permute_gather=True)
COSINE = Measure("cosine", l2_normalize_rows, None, (-1.0, 1.0),
                 permute_gather=True, from_moments=cosine_from_moments)
COVARIANCE = Measure("covariance", center_rows, _cov_epilogue, None,
                     epilogue_div=_cov_div, permute_gather=True,
                     from_moments=covariance_from_moments)
KENDALL = Measure("kendall", pair_sign_transform, _kendall_epilogue,
                  (-1.0, 1.0), epilogue_div=_kendall_div, exact_int8=True)
KENDALL_B = Measure("kendall_tau_b", pair_sign_tie_scaled_transform, None,
                    (-1.0, 1.0))
DOT = Measure("dot", identity_transform, None, None, permute_gather=True,
              from_moments=dot_from_moments)
# Merge-sort Kendall: the ranks as operand, Knight's O(l log l) count per
# pair in the tile kernel; tau-a bitwise KENDALL's sign-GEMM (the same
# integer C - D, the same EpilogueSpec).  resolve_tile_kernel substitutes
# them for KENDALL / KENDALL_B from the crossover on; naming them forces
# the merge path at any l.
KENDALL_MERGE = Measure(
    "kendall_merge", kendall_rank_transform, _kendall_epilogue, (-1.0, 1.0),
    epilogue_div=_kendall_div, tile_kernel=kendall_merge_tile_kernel)
KENDALL_B_MERGE = Measure(
    "kendall_tau_b_merge", kendall_rank_transform, None, (-1.0, 1.0),
    tile_kernel=kendall_tau_b_merge_tile_kernel)
# Distinct objects that pin the sign-GEMM path at any l: the merge
# substitution is by identity (`meas is KENDALL`), so these never switch.
KENDALL_SIGN = dataclasses.replace(KENDALL, name="kendall_sign_gemm")
KENDALL_B_SIGN = dataclasses.replace(KENDALL_B,
                                     name="kendall_tau_b_sign_gemm")
# The merge variants compute their sign-GEMM twins' statistic, so the
# twin's dense inner product is their oracle (dense_reference).
_DENSE_TWIN = {id(KENDALL_MERGE): KENDALL, id(KENDALL_B_MERGE): KENDALL_B}

_REGISTRY: Dict[str, Measure] = {
    "pearson": PEARSON,
    "pcc": PEARSON,
    "spearman": SPEARMAN,
    "cosine": COSINE,
    "covariance": COVARIANCE,
    "cov": COVARIANCE,
    "kendall": KENDALL,
    "kendall_tau_a": KENDALL,
    "kendall_tau_b": KENDALL_B,
    "kendall_b": KENDALL_B,
    "kendall_merge": KENDALL_MERGE,
    "kendall_tau_b_merge": KENDALL_B_MERGE,
    "kendall_sign_gemm": KENDALL_SIGN,
    "kendall_tau_b_sign_gemm": KENDALL_B_SIGN,
    "dot": DOT,
}

MeasureLike = Union[str, Measure]


def get(measure: MeasureLike) -> Measure:
    """Resolve a measure name (or pass a Measure through)."""
    if isinstance(measure, Measure):
        return measure
    try:
        return _REGISTRY[measure]
    except KeyError:
        raise ValueError(
            f"unknown measure {measure!r}; available: {available()}") from None


def register(measure: Measure, *aliases: str) -> Measure:
    """Register a user-defined measure (and optional aliases)."""
    for key in (measure.name, *aliases):
        _REGISTRY[key] = measure
    return measure


def available() -> Tuple[str, ...]:
    return tuple(sorted(set(m.name for m in _REGISTRY.values())))


def resolve_fusion(meas: Measure, fuse_epilogue: bool, l: int, *,
                   clip: bool = True) -> Tuple[Optional[EpilogueSpec], bool]:
    """Decide whether the epilogue fuses into the kernel and build its spec.

    Returns (spec, fused).  When not fused the caller runs the epilogue on
    the pass stream and the sink clips after assembly.
    """
    fused = fuse_epilogue and meas.fusable
    spec = meas.fused_spec(l, clip=clip) if fused else None
    return spec, fused


def resolve_tile_kernel(meas: Measure, *, l: int, compute_dtype=None,
                        replicas: int = 0) -> Measure:
    """The reference's Kendall auto-dispatch, at plan creation.

    At l >= KENDALL_MERGE_CROSSOVER_L the canonical KENDALL / KENDALL_B
    become KENDALL_MERGE / KENDALL_B_MERGE, whose operand is O(l) where the
    pair signs are O(l^2).  The substitution is by identity, so named
    variants (KENDALL_SIGN, KENDALL_MERGE, clones) pass through, and only
    where the merge kernel applies: no compute_dtype (ranks must keep their
    ties; int8 asks for the exact sign-GEMM operand) and no replica axis
    (significance runs ride the sign-GEMM's).
    """
    if compute_dtype is not None or replicas:
        return meas
    if l < KENDALL_MERGE_CROSSOVER_L:
        return meas
    if meas is KENDALL:
        return KENDALL_MERGE
    if meas is KENDALL_B:
        return KENDALL_B_MERGE
    return meas


# -- dense references (oracles) -------------------------------------------------


def dense_reference(x: torch.Tensor, measure: MeasureLike = "pearson", *,
                    clip: bool = True) -> torch.Tensor:
    """Full (n, n) similarity via dense U U^T: the oracle of the tiled
    paths for any inner-product measure (the merge-sort Kendall variants
    answer through their sign-GEMM twins)."""
    return dense_reference_pair(x, x, measure, clip=clip)


def dense_reference_pair(x: torch.Tensor, y: torch.Tensor,
                         measure: MeasureLike = "pearson", *,
                         clip: bool = True) -> torch.Tensor:
    """Rectangular (n_rows, n_cols) cross-similarity via dense U V^T; the
    row transforms are per-row maps, so x and y transform independently."""
    meas = get(measure)
    meas = _DENSE_TWIN.get(id(meas), meas)
    if meas.tile_kernel is not None:
        raise ValueError(
            f"measure {meas.name!r} is not an inner product of its "
            f"transform output (custom tile kernel): use corr() or, for "
            f"kendall, the kendall_tau_a_literal oracle")
    l = x.shape[1]
    if y.shape[1] != l:
        raise ValueError(f"sample counts differ: x has l={l}, y has "
                         f"l={y.shape[1]}")
    u = meas.transform(x, dtype=_acc_dtype(x))
    v = u if y is x else meas.transform(y, dtype=_acc_dtype(y))
    return meas.finalize(u @ v.T, l, clip=clip)


# -- pairwise-complete (masked) measures ------------------------------------------
# With missing values each pair is scored over its common observed samples.
# With A the values zeroed where missing, M the 0/1 mask and A2 = A * A, the
# per-pair sums are six products of the same engine:
#   sxy = A A'^T, n = M M'^T, sx = A M'^T, sy = M A'^T, qx = A2 M'^T,
#   qy = M A2'^T,
# and a MaskedMeasure combines the finished tiles elementwise.  Degenerate
# pairs (fewer than 2 common samples, or zero variance / norm on the common
# support) score 0.  Combines return unclipped values; the sink clips iff
# the caller asked for it, as on any unfused run.


@dataclasses.dataclass(frozen=True)
class MaskedMeasure:
    """A pairwise-complete similarity as component products plus an
    elementwise combine.  `components` is a subset of {sxy, n, sx, sy, qx,
    qy}; `combine` maps the per-tile component dict to finished values."""

    name: str
    base: str                      # unmasked counterpart (registry name)
    components: Tuple[str, ...]
    combine: Callable[[Dict[str, torch.Tensor]], torch.Tensor]
    clip: Optional[Tuple[float, float]] = None


def _masked_pearson_combine(p: Dict[str, torch.Tensor]) -> torch.Tensor:
    n, sxy, sx, sy = p["n"], p["sxy"], p["sx"], p["sy"]
    cov = n * sxy - sx * sy
    vx = n * p["qx"] - sx * sx
    vy = n * p["qy"] - sy * sy
    den = torch.sqrt(torch.clamp(vx, min=0.0) * torch.clamp(vy, min=0.0))
    ok = (n >= 2.0) & (den > 0.0)
    return torch.where(ok, cov / torch.where(ok, den, 1.0), 0.0)


def _masked_cosine_combine(p: Dict[str, torch.Tensor]) -> torch.Tensor:
    den = torch.sqrt(torch.clamp(p["qx"], min=0.0)
                     * torch.clamp(p["qy"], min=0.0))
    ok = den > 0.0
    return torch.where(ok, p["sxy"] / torch.where(ok, den, 1.0), 0.0)


def _masked_cov_combine(p: Dict[str, torch.Tensor]) -> torch.Tensor:
    n = p["n"]
    ok = n >= 2.0
    safe_n = torch.where(ok, n, 1.0)
    c = (p["sxy"] - p["sx"] * p["sy"] / safe_n) / torch.clamp(safe_n - 1.0,
                                                              min=1.0)
    return torch.where(ok, c, 0.0)


MASKED_PEARSON = MaskedMeasure(
    "pearson_complete", "pearson", ("sxy", "n", "sx", "sy", "qx", "qy"),
    _masked_pearson_combine, (-1.0, 1.0))
MASKED_COSINE = MaskedMeasure(
    "cosine_complete", "cosine", ("sxy", "qx", "qy"),
    _masked_cosine_combine, (-1.0, 1.0))
MASKED_COVARIANCE = MaskedMeasure(
    "covariance_complete", "covariance", ("sxy", "n", "sx", "sy"),
    _masked_cov_combine, None)

_MASKED_REGISTRY: Dict[str, MaskedMeasure] = {
    "pearson": MASKED_PEARSON,
    "pcc": MASKED_PEARSON,
    "pearson_complete": MASKED_PEARSON,
    "cosine": MASKED_COSINE,
    "cosine_complete": MASKED_COSINE,
    "covariance": MASKED_COVARIANCE,
    "cov": MASKED_COVARIANCE,
    "covariance_complete": MASKED_COVARIANCE,
}


# the masked measures' own names, as a masked run's plan carries them
MASKED_NAMES = tuple(sorted(set(m.name for m in _MASKED_REGISTRY.values())))


def get_masked(measure) -> MaskedMeasure:
    """Resolve the pairwise-complete variant of a measure for masked runs
    (``corr(..., where=)``)."""
    if isinstance(measure, MaskedMeasure):
        return measure
    name = measure.name if isinstance(measure, Measure) else measure
    try:
        return _MASKED_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"measure {name!r} has no pairwise-complete (masked) variant; "
            f"available: {MASKED_NAMES} "
            f"(rank-based measures need joint re-ranking per pair, which "
            f"does not factor into per-row GEMM operands)") from None


def masked_operands(x: torch.Tensor,
                    mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Derived row operands of one masked side: zeroed values A, the 0/1
    mask M, and the zeroed squares A2 (float32)."""
    m = torch.as_tensor(mask, device=x.device).to(torch.float32)
    a = torch.where(m > 0, torch.nan_to_num(x.to(torch.float32)), 0.0)
    return {"a": a, "m": m, "a2": a * a}


# component name -> (row-side operand key, col-side operand key)
MASKED_COMPONENT_OPERANDS: Dict[str, Tuple[str, str]] = {
    "sxy": ("a", "a"),
    "n": ("m", "m"),
    "sx": ("a", "m"),
    "sy": ("m", "a"),
    "qx": ("a2", "m"),
    "qy": ("m", "a2"),
}


def masked_dense_reference(x: torch.Tensor, mask_x: torch.Tensor,
                           y: Optional[torch.Tensor] = None,
                           mask_y: Optional[torch.Tensor] = None,
                           measure="pearson", *,
                           clip: bool = True) -> torch.Tensor:
    """Dense pairwise-complete oracle: the same component products as the
    tiled masked path, each one float32 matmul.  y=None scores x against
    itself (the full square)."""
    mm = get_masked(measure)
    ox = masked_operands(x, mask_x)
    oy = ox if y is None else masked_operands(y, mask_y)
    parts = {}
    for comp in mm.components:
        rk, ck = MASKED_COMPONENT_OPERANDS[comp]
        parts[comp] = ox[rk] @ oy[ck].T
    r = mm.combine(parts)
    if clip and mm.clip is not None:
        r = torch.clamp(r, *mm.clip)
    return r


def kendall_tau_a_literal(x) -> np.ndarray:
    """O(n^2 l^2) literal Kendall tau-a (float64, host numpy): (concordant
    - discordant) / C(l, 2), ties counting 0.  The (n, l, l) sign tensor
    counts each unordered sample pair twice, hence the / 2."""
    xn = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x,
                    np.float64)
    n, l = xn.shape
    if l < 2:
        raise ValueError(f"kendall needs at least 2 samples, got l={l}")
    s = np.sign(xn[:, :, None] - xn[:, None, :])
    g = np.einsum("iab,jab->ij", s, s) / 2.0
    return g / (l * (l - 1) // 2)


__all__ = ["Measure", "MeasureLike", "MaskedMeasure", "MASKED_PEARSON",
           "MASKED_COSINE", "MASKED_COVARIANCE",
           "MASKED_COMPONENT_OPERANDS", "MASKED_NAMES", "get_masked", "masked_operands",
           "masked_dense_reference", "PEARSON", "SPEARMAN", "COSINE",
           "COVARIANCE", "KENDALL", "KENDALL_B", "DOT", "KENDALL_SIGN",
           "KENDALL_B_SIGN", "KENDALL_MERGE", "KENDALL_B_MERGE",
           "KENDALL_MERGE_CROSSOVER_L", "get", "register",
           "available", "resolve_fusion", "resolve_tile_kernel",
           "rank_rows", "spearman_transform", "l2_normalize_rows",
           "center_rows", "pair_sign_transform", "kendall_rank_transform",
           "pair_sign_tie_scaled_transform", "identity_transform",
           "pearson_from_moments", "cosine_from_moments",
           "covariance_from_moments", "dot_from_moments",
           "dense_reference", "dense_reference_pair",
           "kendall_tau_a_literal"]
