"""Similarity measures for the triangular all-pairs engine (Pearson).

Port of the ``Measure`` record of ``repro/core/measures.py``.  A measure is
a row transform plus an elementwise epilogue around the shared tile kernel:

    S(X_i, X_j) = epilogue(<row_transform(X)_i, row_transform(X)_j>, l)

This slice carries Pearson (center + L2-normalise, identity epilogue, clip
to [-1, 1]).  The other measures of the reference come with ROADMAP slice 3.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple, Union

import torch

from repro_torch.core import pcc
from repro_torch.kernels.pcc_tile import EpilogueSpec


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
    """

    name: str
    transform: Callable[..., torch.Tensor]
    epilogue: Optional[Callable[[torch.Tensor, int], torch.Tensor]] = None
    clip: Optional[Tuple[float, float]] = None
    epilogue_div: Optional[Callable[[int], float]] = None

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


PEARSON = Measure("pearson", pcc.transform, None, (-1.0, 1.0))

_REGISTRY = {"pearson": PEARSON, "pcc": PEARSON}
_LATER = ("spearman", "cosine", "covariance", "cov", "kendall",
          "kendall_tau_a", "kendall_tau_b", "kendall_b", "kendall_merge",
          "kendall_tau_b_merge", "kendall_sign_gemm",
          "kendall_tau_b_sign_gemm", "dot")

MeasureLike = Union[str, Measure]


def get(measure: MeasureLike) -> Measure:
    """Resolve a measure name (or pass a Measure through)."""
    if isinstance(measure, Measure):
        return measure
    if measure in _REGISTRY:
        return _REGISTRY[measure]
    if measure in _LATER:
        raise NotImplementedError(
            f"measure {measure!r} is not ported yet (ROADMAP slice 3); "
            f"this slice carries 'pearson'")
    raise ValueError(f"unknown measure {measure!r}; available: ('pearson',)")


def resolve_fusion(meas: Measure, fuse_epilogue: bool, l: int, *,
                   clip: bool = True) -> Tuple[Optional[EpilogueSpec], bool]:
    """Decide whether the epilogue fuses into the kernel and build its spec.

    Returns (spec, fused).  When not fused the caller runs the epilogue on
    the pass stream and the sink clips after assembly.
    """
    fused = fuse_epilogue and meas.fusable
    spec = meas.fused_spec(l, clip=clip) if fused else None
    return spec, fused


__all__ = ["Measure", "MeasureLike", "PEARSON", "get", "resolve_fusion"]
