"""Gene-expression input data (the paper's input domain).

Copy of the artificial-data part of ``repro/data/expression.py``: the paper
evaluates on expression values uniform in [0, 1] — "reasonable because the
runtime of PCC computation is merely subject to n and l and independent of
expression values" (SSIV-A).  numpy's ``default_rng(seed)`` makes the bytes
identical to the reference package's for the same spec.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ExpressionSpec:
    n: int
    l: int
    seed: int = 0


def artificial(spec: ExpressionSpec, dtype=np.float32) -> np.ndarray:
    """Paper SSIV-A artificial data: values uniform in [0, 1]."""
    rng = np.random.default_rng(spec.seed)
    return rng.random((spec.n, spec.l), dtype=np.float32).astype(dtype)


__all__ = ["ExpressionSpec", "artificial"]
