"""Triangular all-pairs correlation tiles: wrapper, plain version, epilogue.

Port of ``repro/kernels/pcc_tile.py::pcc_tiles`` (Pallas body ``_kernel``)
in its triangular, float32, fused-epilogue mode.  ``pass_tiles`` consecutive
(t, t) tiles of U U^T start at the runtime tile id ``j_start``; each id is
inverted to its (y, x) tile coordinate by the upper-triangle bijection, the
tile accumulates over the whole sample axis in IEEE float32, and the fused
:class:`EpilogueSpec` (x 1/div, then clip) runs before the single store.
Ids past the end clamp to the last tile.

Dispatch is by the operand's device: a CUDA tensor launches the CUDA kernel
(kernels/csrc/pcc_tile.cu) or raises; a CPU tensor runs
:func:`pcc_tiles_plain`, a direct PyTorch transcription of the same
semantics that is also the kernel's reference on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.mapping import job_coord_batch

DEFAULT_TILE = 256
DEFAULT_LBLK = 512


@dataclasses.dataclass(frozen=True)
class EpilogueSpec:
    """Kernel-inlinable elementwise epilogue: v -> clip(v * (1/div), lo, hi).

    `div` is the measure's static denominator or None for identity; `clip`
    is the bounded-measure output range or None.  The division is
    canonically a multiply by the float32-rounded reciprocal, so the fused
    (in-kernel) and unfused (``apply`` on the pass stream) paths give the
    same bits; the CUDA kernel receives that reciprocal from
    :meth:`kernel_args`.
    """

    div: Optional[float] = None
    clip: Optional[Tuple[float, float]] = None

    def is_identity(self) -> bool:
        return self.div is None and self.clip is None

    def recip(self) -> np.float32:
        return np.float32(1.0) / np.float32(self.div)

    def apply(self, vals: torch.Tensor) -> torch.Tensor:
        if self.div is not None:
            vals = vals * float(self.recip())
        if self.clip is not None:
            vals = torch.clamp(vals, self.clip[0], self.clip[1])
        return vals

    def kernel_args(self) -> Tuple[int, float, int, float, float]:
        """(has_div, recip, has_clip, lo, hi) as the kernel takes them."""
        has_div = self.div is not None
        has_clip = self.clip is not None
        lo, hi = self.clip if has_clip else (0.0, 0.0)
        return (int(has_div), float(self.recip()) if has_div else 1.0,
                int(has_clip), float(lo), float(hi))


def _check(u_pad: torch.Tensor, j_start: int, t: int, l_blk: int,
           pass_tiles: int) -> Tuple[int, int]:
    """Validate a launch; returns (m, total)."""
    if not isinstance(u_pad, torch.Tensor) or u_pad.ndim != 2:
        raise ValueError("u_pad must be a 2-D torch tensor")
    if u_pad.device.type not in ("cuda", "cpu"):
        raise ValueError(f"u_pad on unsupported device {u_pad.device}")
    if u_pad.dtype != torch.float32:
        raise ValueError(f"u_pad must be float32, got {u_pad.dtype} "
                         f"(narrower operands are a later slice)")
    if not u_pad.is_contiguous():
        raise ValueError("u_pad must be contiguous")
    n_pad, l_pad = u_pad.shape
    if t <= 0 or l_blk <= 0 or n_pad == 0 or n_pad % t or l_pad % l_blk:
        raise ValueError(f"u_pad {tuple(u_pad.shape)} not aligned to t={t}, "
                         f"l_blk={l_blk}")
    if pass_tiles <= 0:
        raise ValueError(f"pass_tiles must be positive, got {pass_tiles} "
                         f"(remainder launches must be sized, not empty)")
    if j_start < 0:
        raise ValueError(f"j_start must be non-negative, got {j_start}")
    m = n_pad // t
    return m, m * (m + 1) // 2


def pcc_tiles(u_pad: torch.Tensor, j_start: int, *, t: int = DEFAULT_TILE,
              l_blk: int = DEFAULT_LBLK, pass_tiles: int,
              epilogue: Optional[EpilogueSpec] = None) -> torch.Tensor:
    """Compute `pass_tiles` consecutive tiles from tile id `j_start`.

    u_pad: (n_pad, l_pad) float32 transformed variables (Eq. 4), zero-padded
           so n_pad % t == 0 and l_pad % l_blk == 0, contiguous.
    epilogue: optional EpilogueSpec applied before the store.
    Returns (pass_tiles, t, t) float32.  ``pcc_tiles.launches`` counts the
    CUDA kernel's launches.
    """
    j_start = int(j_start)
    m, _ = _check(u_pad, j_start, t, l_blk, pass_tiles)
    if u_pad.device.type == "cpu":
        return pcc_tiles_plain(u_pad, j_start, t=t, l_blk=l_blk,
                               pass_tiles=pass_tiles, epilogue=epilogue)
    from repro_torch.kernels import _build

    lib = _build.load("pcc_tile")
    spec = epilogue if epilogue is not None else EpilogueSpec()
    has_div, recip, has_clip, lo, hi = spec.kernel_args()
    out = torch.empty((pass_tiles, t, t), dtype=torch.float32,
                      device=u_pad.device)
    with torch.cuda.device(u_pad.device):
        stream = torch.cuda.current_stream(u_pad.device).cuda_stream
        err = lib.pcc_tiles_f32_tri(
            ctypes.c_void_p(u_pad.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            j_start, pass_tiles, m, t, u_pad.shape[1],
            has_div, recip, has_clip, lo, hi, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"pcc_tiles launch failed: "
                           f"{lib.pcc_tile_error_string(err).decode()}")
    pcc_tiles.launches += 1
    return out


pcc_tiles.launches = 0


def pcc_tiles_plain(u_pad: torch.Tensor, j_start: int, *,
                    t: int = DEFAULT_TILE, l_blk: int = DEFAULT_LBLK,
                    pass_tiles: int,
                    epilogue: Optional[EpilogueSpec] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`pcc_tiles`, on any device.

    Transcribes the Pallas grid: tile ids invert on the host with the exact
    ``job_coord_batch``, each (t, l_blk) row and column block pair adds its
    float32 product into the tile, then the epilogue runs.  On the card,
    callers set ``torch.backends.cuda.matmul.allow_tf32 = False`` (the
    default) so the products stay IEEE float32.
    """
    j_start = int(j_start)
    m, total = _check(u_pad, j_start, t, l_blk, pass_tiles)
    ids = np.minimum(j_start + np.arange(pass_tiles, dtype=np.int64),
                     total - 1)
    ys, xs = job_coord_batch(m, ids)
    dev = u_pad.device
    ys = torch.as_tensor(ys, device=dev)
    xs = torch.as_tensor(xs, device=dev)
    u3 = u_pad.view(m, t, u_pad.shape[1])
    acc = torch.zeros((pass_tiles, t, t), dtype=torch.float32, device=dev)
    for k0 in range(0, u_pad.shape[1], l_blk):
        rows = u3[ys, :, k0:k0 + l_blk]
        cols = u3[xs, :, k0:k0 + l_blk]
        acc += torch.bmm(rows, cols.transpose(1, 2))
    if epilogue is not None and not epilogue.is_identity():
        acc = epilogue.apply(acc)
    return acc


__all__ = ["DEFAULT_TILE", "DEFAULT_LBLK", "EpilogueSpec", "pcc_tiles",
           "pcc_tiles_plain"]
