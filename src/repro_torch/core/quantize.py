"""Per-row absmax quantization for non-integer operand transforms.

Port of ``repro/core/quantize.py``.  Each transformed row is scaled into the
stored type's range by its own absmax:

* int8: ``q[i] = clip(round(u[i] / s[i]), -127, 127)`` with
  ``s[i] = absmax_i / 127``.  The tile kernel sums the int8 products
  exactly in int32, converts once and multiplies the finished tile by the
  scale product ``s[y] * s[x]`` before the fused epilogue.
* fp8 (``float8_e4m3fn``, ``float8_e5m2``): the same absmax pre-scaling
  onto the fp8 range (448 or 57,344), then the cast.  The kernel widens each
  fp8 code to float32 as it loads it (exact) and takes the float32 FMA
  chain; the scales apply as for int8.  Support is probed once per process
  (:func:`fp8_supported`), never assumed.

The quantized operand travels as an :class:`Operand` of ``(data, scale)``;
the executor unwraps it with :func:`operand_parts` at the kernel launch.
Exactly-integer transforms (Kendall's pair signs, ``exact_int8`` measures)
do not use this module: their int8 operand is stored as it is, with no
scale (``plan.needs_row_scales``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels.pcc_tile import dtype_name

# Largest magnitude of each quantized type: a row's absmax lands on it.
QMAX = {
    "int8": 127.0,
    "float8_e4m3fn": 448.0,
    "float8_e5m2": 57344.0,
}
_FP8_NAMES = ("float8_e4m3fn", "float8_e5m2")


@dataclasses.dataclass
class Operand:
    """A quantized operand: ``data`` (n_pad, l_pad) in the stored type and
    ``scale`` (n_pad,) float32 per-row dequantization factors (absmax /
    qmax; padding rows carry scale 0)."""

    data: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def ndim(self) -> int:
        return self.data.ndim

    def __getitem__(self, idx) -> "Operand":
        """Row-slice data and scales together."""
        return Operand(self.data[idx], self.scale[idx])


def operand_parts(u) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(data, scale or None) of an operand."""
    if isinstance(u, Operand):
        return u.data, u.scale
    return u, None


def operand_data(u) -> torch.Tensor:
    return u.data if isinstance(u, Operand) else u


def quantize_rows(u: torch.Tensor, qdtype) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """Per-row absmax quantization of a float operand.

    Returns ``(q, scale)``: ``q[i] = round_or_cast(u[i] / scale[i])`` in
    ``qdtype`` and ``scale[i] = absmax_i / qmax`` (float32).  All-zero rows
    get scale 0 and quantize to zero rows, inert in the kernel like zero
    padding.  Every division is tensor by tensor (on the card, PyTorch
    turns a division by a host scalar into a multiply by its reciprocal,
    which can differ in the last bit).  int8 rounds half to even, as
    ``jnp.round`` does, then clips; fp8 clips, then casts (round to nearest
    even).
    """
    name = dtype_name(qdtype)
    qdtype = getattr(torch, name)
    u = u.to(torch.float32)
    qmax = torch.tensor(QMAX[name], dtype=torch.float32, device=u.device)
    scale = u.abs().amax(dim=1) / qmax
    # zero rows: divide by 1 instead of 0 (their values are all 0)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    scaled = u / safe[:, None]
    if is_fp8(qdtype):
        q = torch.clamp(scaled, -qmax, qmax).to(qdtype)
    else:
        q = torch.clamp(torch.round(scaled), -qmax, qmax).to(qdtype)
    return q, scale


def is_fp8(dtype) -> bool:
    return dtype_name(dtype) in _FP8_NAMES


@functools.lru_cache(maxsize=None)
def fp8_supported(name: str = "float8_e4m3fn") -> bool:
    """Whether this torch has the fp8 type `name` and can widen it: an 8 x 8
    block cast in and back out must return its ones.  Probed once per
    process; the kernel widens fp8 itself, so nothing else is needed."""
    try:
        dt = getattr(torch, name)
        if not isinstance(dt, torch.dtype):
            return False
        ones = torch.ones((8, 8), dtype=torch.float32)
        return bool(torch.equal(ones.to(dt).to(torch.float32), ones))
    except Exception:
        return False


def fp8_dtype() -> Optional[torch.dtype]:
    """The preferred supported fp8 type, or None if torch has none."""
    for name in _FP8_NAMES:
        if fp8_supported(name):
            return getattr(torch, name)
    return None


__all__ = ["QMAX", "Operand", "fp8_dtype", "fp8_supported", "is_fp8",
           "operand_data", "operand_parts", "quantize_rows"]
