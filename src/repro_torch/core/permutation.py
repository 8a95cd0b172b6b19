"""The legacy permutation-testing entry point (paper SSIV), deprecated.

Port of ``repro/core/permutation.py``: ``permutation_pvalues`` is a thin
wrapper over the engine's significance workload,
``corr(x, pvalues=PermutationSpec(...))`` (core/significance.py), so its
p-values do not depend on ``chunk`` and its replica launches are
exact-sized.  ``key=None`` keeps the legacy fixed seed (0) but warns: the
new API requires an explicit key.  The returned p is the engine's
canonical symmetric output; ``precision`` is accepted and ignored (the
kernel accumulates in float32).
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import torch

from repro_torch.core.significance import KeyLike, PermutationSpec


def permutation_pvalues(x, *, iterations: int = 1000, chunk: int = 64,
                        key: Optional[KeyLike] = None, precision=None,
                        device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (R, pvalues), each (n, n): Pearson significance through the
    replica axis.  Deprecated spelling of ``corr(x, pvalues=
    PermutationSpec(iterations=..., key=..., chunk=...), device=device)``.
    """
    del precision  # the kernel always accumulates in float32
    if key is None:
        warnings.warn(
            "permutation_pvalues(key=None) falls back to the fixed seed 0: "
            "repeated 'independent' runs draw identical null permutations. "
            " Pass an explicit key= (the corr(pvalues=PermutationSpec(...)) "
            "API requires one).", UserWarning, stacklevel=2)
        key = 0
    from repro_torch.core.api import corr  # api builds on significance
    return corr(x, pvalues=PermutationSpec(iterations=iterations, key=key,
                                           chunk=chunk), device=device)


__all__ = ["permutation_pvalues"]
