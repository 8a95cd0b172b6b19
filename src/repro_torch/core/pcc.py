"""Pearson correlation: reformulation (paper SSIII-A) and reference forms.

Port of ``repro/core/pcc.py``:

* ``pearson_literal`` — Eq. (1), the per-pair formula in float64 (the role
  of the paper's ALGLIB sequential baseline); ``pearson_pair_literal`` for
  one pair.
* ``transform``       — Eq. (4): X_i -> U_i = (X_i - mean) / ||X_i - mean||_2.
* ``pearson_gemm``    — Eq. (5): R = U U^T, the dense oracle;
  ``pearson_from_u`` for a transformed U.
* ``flops_allpairs``  — the paper's SSIII-E cost model.

The production triangular path is core/allpairs.py + kernels/pcc_tile.py.
"""

from __future__ import annotations

import torch


def _stat_dtype(dtype: torch.dtype) -> torch.dtype:
    """Statistics are taken in at least float32."""
    return torch.promote_types(dtype, torch.float32)


def transform(x: torch.Tensor, *, dtype=None) -> torch.Tensor:
    """Variable transformation, Eq. (4) / Alg. 3.

    x: (n, l) matrix of n variables with l samples each.  Returns U with
    rows U_i = (X_i - mean_i) / ||X_i - mean_i||_2, so r(X_i, X_j) =
    <U_i, U_j>.  Zero-variance rows (exact ``norm > 0`` test) map to
    all-zero rows, so every pair involving them scores 0.
    """
    if x.ndim != 2:
        raise ValueError(f"expected (n, l) matrix, got shape {tuple(x.shape)}")
    xa = x.to(_stat_dtype(x.dtype))
    centered = xa - xa.mean(dim=1, keepdim=True)
    norm = torch.sqrt((centered * centered).sum(dim=1, keepdim=True))
    live = norm > 0
    u = torch.where(live, centered / torch.where(live, norm, 1.0), 0.0)
    return u.to(dtype or x.dtype)


def pearson_pair_literal(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Eq. (1) verbatim for a single pair (the ALGLIB role), float64."""
    u = u.to(torch.float64)
    v = v.to(torch.float64)
    du = u - u.mean()
    dv = v - v.mean()
    num = (du * dv).sum()
    den = torch.sqrt((du * du).sum() * (dv * dv).sum())
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)


def pearson_literal(x: torch.Tensor) -> torch.Tensor:
    """All-pairs Eq. (1) in float64, per-pair statistics recomputed."""
    x = x.to(torch.float64)
    d = x[:, None, :] - x.mean(dim=1)[:, None, None]   # du for row i
    e = x[None, :, :] - x.mean(dim=1)[None, :, None]   # dv for row j
    num = (d * e).sum(dim=2)
    den = torch.sqrt((d * d).sum(dim=2) * (e * e).sum(dim=2))
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)


def pearson_gemm(x: torch.Tensor) -> torch.Tensor:
    """Eq. (5): transform then the full R = U U^T (the dense oracle)."""
    u = transform(x, dtype=_stat_dtype(x.dtype))
    return torch.clamp(u @ u.T, -1.0, 1.0)


def pearson_from_u(u: torch.Tensor) -> torch.Tensor:
    """R = U U^T for a transformed U (Eq. 5), clipped to [-1, 1]."""
    return torch.clamp(u @ u.T, -1.0, 1.0)


def flops_allpairs(n: int, l: int) -> int:
    """Paper SSIII-E cost model: 5 l n (transform) + l n (n + 1) / 2 unit
    FMA operations.  In FLOPs (multiply and add counted apart) the product
    part is ~ l n (n + 1)."""
    return 5 * l * n + l * n * (n + 1) // 2


__all__ = ["transform", "pearson_pair_literal", "pearson_literal",
           "pearson_gemm", "pearson_from_u", "flops_allpairs"]
