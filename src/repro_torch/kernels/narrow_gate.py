"""The narrow gate: how far the tensor-core tiles of bfloat16, float16 and
fp8 operands (kernels/csrc/pcc_tile_sm90.cu) may lie from the plain version's,
and the two planted faults it is shown to refuse.

The tensor cores sum the same exact products as the plain version in
another order, with their own adders, so their tiles are held to a bound
per output rather than bitwise:

    |kernel - plain| <= (c * 2^-24 * sqrt(l_pad) + a * 2^-13) * G,
    G = |s_row| |s_col| (|A| |B|^T)[i, j] / |div|

(:func:`narrow_gate`).  A check reads a result as :func:`gate_share`, its
largest distance as a share of the gate (<= 1 passes), and shows with
:func:`planted_fault_shares` that a faulty kernel would read at least
FAULT_SHARE.  On a CUDA tensor the faults run the kernel; on a CPU tensor
the plain version.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.pcc_tile import (DEFAULT_LBLK, DEFAULT_TILE,
                                          EpilogueSpec, dtype_name,
                                          pcc_tiles, pcc_tiles_plain)

# The gate's constants per tensor-core operand dtype: c, the multiple of
# 2^-24 sqrt(l_pad) for the float32 sums of both sides, and a, the multiple
# of 2^-13 for fp8's 13-bit sums between promotions.  float16 is argued as
# bfloat16 is: its unit roundoff 2^-11 (bf16: 2^-8) is spent when the
# operands are stored, and both sides read the same stored codes; the
# product of two 11-bit significands has at most 22 bits, so it is exact
# in float32 on both sides, and the sums are float32 on both (wgmma
# f32.f16.f16).  What remains is the float32 sum walk, c = 16, and no
# 2^-13 term, a = 0.
NARROW_GATE = {"bfloat16": (16.0, 0.0), "float16": (16.0, 0.0),
               "float8_e4m3fn": (16.0, 16.0), "float8_e5m2": (16.0, 16.0)}
# The planted faults: a chunk of samples as long as the fp8 kernel's
# promotion interval, and how far outside the gate each must read.
FAULT_CHUNK = 128
FAULT_SHARE = 10.0
_FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)


def narrow_gate_unit(dtype, l_pad: int) -> float:
    """The gate's multiple of G for operands of `dtype` over l_pad samples:
    c * 2^-24 * sqrt(l_pad) + a * 2^-13 (see :func:`narrow_gate`)."""
    c, a = NARROW_GATE[dtype_name(dtype)]
    return c * 2.0 ** -24 * math.sqrt(l_pad) + a * 2.0 ** -13


def narrow_gate(u_pad: torch.Tensor, j_start: int, *, t: int = DEFAULT_TILE,
                l_blk: int = DEFAULT_LBLK, pass_tiles: int,
                epilogue: Optional[EpilogueSpec] = None,
                v_pad: Optional[torch.Tensor] = None,
                grid_cols: Optional[int] = None,
                row_scale: Optional[torch.Tensor] = None,
                col_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per output of :func:`pcc_tiles` on these arguments (bfloat16, float16
    or fp8 operands), the bound on its distance from :func:`pcc_tiles_plain`'s:

        |kernel - plain| <= (c * 2^-24 * sqrt(l_pad) + a * 2^-13) * G,
        G = |s_row| |s_col| (|A| |B|^T)[i, j] / |div|,

    G from the plain version on the magnitudes of the operands and scales,
    with the epilogue's division and without its clip (a clip moves two
    values no further apart).  Both sides sum the same exact products in
    other orders, each rounding a partial sum of magnitude at most G.  The
    first term is that walk in float32 (unit roundoff 2^-24, ~sqrt(l_pad)
    roundings), c = 16 for both sides and the tensor cores' truncating
    adders.  The second is fp8's: the tensor cores keep 13 fraction bits in
    the sums between the kernel's promotions (every 128 samples, four k32
    steps), so each chunk's partial moves by up to a few 2^-13 of its share
    of G whatever l_pad, and a = 16 (NARROW_GATE; 0 for bf16 and fp16,
    whose sums keep float32's bits)."""
    mag = (lambda x: None if x is None else x.float().abs())
    spec = epilogue if epilogue is not None else EpilogueSpec()
    div = None if spec.div is None else abs(spec.div)
    g = pcc_tiles_plain(mag(u_pad), j_start, t=t, l_blk=l_blk,
                        pass_tiles=pass_tiles, epilogue=EpilogueSpec(div=div),
                        v_pad=mag(v_pad), grid_cols=grid_cols,
                        row_scale=mag(row_scale), col_scale=mag(col_scale))
    return g * narrow_gate_unit(u_pad.dtype, u_pad.shape[-1])


def planted_faults(u_pad: torch.Tensor, v_pad: Optional[torch.Tensor],
                   l_blk: int):
    """The two faults the narrow gate is shown to refuse, as (name, u', v')
    operand pairs for the kernel (v' None where v_pad is None): U's first
    FAULT_CHUNK samples zeroed ("chunk zeroed"), and those samples of U (and
    of V) appended once more, so that the product counts them twice ("chunk
    twice"; zero-padded to a multiple of l_blk)."""
    def raw(x):   # fp8 moves as bytes
        return x.view(torch.uint8) if x.dtype in _FP8 else x

    def zeroed(x):
        y = raw(x).clone()
        y[..., :FAULT_CHUNK] = 0
        return y.view(x.dtype)

    def twice(x):
        y = torch.cat([raw(x), raw(x)[..., :FAULT_CHUNK]], dim=-1)
        width = -(-y.shape[-1] // l_blk) * l_blk
        pad = torch.zeros(*y.shape[:-1], width - y.shape[-1], dtype=y.dtype,
                          device=y.device)
        return torch.cat([y, pad], dim=-1).view(x.dtype)

    return [("chunk zeroed", zeroed(u_pad), v_pad),
            ("chunk twice", twice(u_pad),
             None if v_pad is None else twice(v_pad))]


def planted_fault_shares(u_pad: torch.Tensor, j_start: int,
                         **kwargs) -> dict:
    """The narrow gate's reading of each planted fault, {name: share}:
    :func:`pcc_tiles` (the kernel on the card, the plain version on the
    CPU) on the faulty operands against :func:`pcc_tiles_plain` on the
    true ones, as a share of :func:`narrow_gate`.  Both run without the
    epilogue's clip, as the gate's G does: the clip pins the values a fault
    may push past it (a doubled chunk lifts Pearson's diagonal above 1).
    `kwargs` are those of pcc_tiles."""
    spec = kwargs.get("epilogue") or EpilogueSpec()
    kw = {**kwargs, "epilogue": EpilogueSpec(div=spec.div)}
    want = pcc_tiles_plain(u_pad, j_start, **kw)
    gate = narrow_gate(u_pad, j_start, **kw)
    return {name: gate_share(pcc_tiles(fu, j_start, **{**kw, "v_pad": fv}),
                             want, gate)
            for name, fu, fv in planted_faults(u_pad, kw.get("v_pad"),
                                               kw["l_blk"])}


def gate_share(got: torch.Tensor, want: torch.Tensor,
               gate: torch.Tensor) -> float:
    """The largest |got - want| / gate (0 where the two are equal, also on
    a zero gate; NaN if either holds a NaN the other does not): <= 1 is
    within the gate."""
    d = (got - want).abs()
    share = torch.where(d == 0, torch.zeros_like(d), d / gate)
    return float(share.max()) if share.numel() else 0.0


__all__ = ["NARROW_GATE", "FAULT_CHUNK", "FAULT_SHARE", "narrow_gate_unit",
           "narrow_gate", "planted_faults", "planted_fault_shares",
           "gate_share"]
