"""Gene-expression input data (the paper's input domain).

Copy of ``repro/data/expression.py``: the paper evaluates on expression
values uniform in [0, 1] — "reasonable because the runtime of PCC
computation is merely subject to n and l and independent of expression
values" (SSIV-A) — and this module adds a generator with planted
co-expression modules standing in for the SEEK GPL570 set, so network
construction has signal to find.  Everything is numpy with
``default_rng(seed)``, so the bytes are the reference package's for the
same spec.  Shards are derivable one at a time (seed + offset), so a
dataset larger than host memory streams shard by shard.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ExpressionSpec:
    n: int
    l: int
    seed: int = 0
    planted_modules: int = 0     # 0 = pure-random (paper artificial data)
    module_strength: float = 0.8


def artificial(spec: ExpressionSpec, dtype=np.float32) -> np.ndarray:
    """Paper SSIV-A artificial data: values uniform in [0, 1]."""
    rng = np.random.default_rng(spec.seed)
    return rng.random((spec.n, spec.l), dtype=np.float32).astype(dtype)


def coexpressed(spec: ExpressionSpec, dtype=np.float32) -> np.ndarray:
    """Planted-module data: rows in the same module share a latent factor,
    giving known-positive correlations (used by the network example).  The
    module of each row is drawn from the same generator right after the
    noise, so ``default_rng(seed)`` replayed gives the labels."""
    rng = np.random.default_rng(spec.seed)
    x = rng.standard_normal((spec.n, spec.l)).astype(np.float64)
    if spec.planted_modules > 0:
        module = rng.integers(0, spec.planted_modules, size=spec.n)
        latents = rng.standard_normal((spec.planted_modules, spec.l))
        s = spec.module_strength
        x = np.sqrt(1 - s * s) * x + s * latents[module]
    return x.astype(dtype)


def row_shards(spec: ExpressionSpec, shard_rows: int,
               planted: bool = False) -> Iterator[Tuple[int, np.ndarray]]:
    """Stream (row_offset, block) shards deterministically; each shard is
    derivable on its own (seed + 1 + offset), so a restarted ingest resumes
    mid-dataset without replaying."""
    gen = coexpressed if planted else artificial
    for lo in range(0, spec.n, shard_rows):
        hi = min(spec.n, lo + shard_rows)
        sub = dataclasses.replace(spec, n=hi - lo, seed=spec.seed + 1 + lo)
        yield lo, gen(sub)


__all__ = ["ExpressionSpec", "artificial", "coexpressed", "row_shards"]
