"""Public wrappers of the kernels, as ``repro/kernels/ops.py`` has them.

Dispatch is by the tensors' device, as everywhere in the port: a CUDA
tensor launches the hand-written kernel or raises, a CPU tensor runs the
kernel's plain version.  The reference's ``impl=`` switch and its
``set_default_impl`` / ``get_default_impl`` are not ported: the port picks
no implementation by a flag.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.pcc_tile import (DEFAULT_LBLK, DEFAULT_TILE,
                                          EpilogueSpec)
from repro_torch.kernels.pcc_tile import pcc_tiles as _pcc_tiles


def pcc_tiles(u_pad: torch.Tensor, j_start, *, t: int = DEFAULT_TILE,
              l_blk: int = DEFAULT_LBLK, pass_tiles: int,
              epilogue: Optional[EpilogueSpec] = None) -> torch.Tensor:
    """Triangular all-pairs correlation tiles (kernels/pcc_tile.py), with
    ``epilogue`` fused into the kernel's store."""
    return _pcc_tiles(u_pad, int(j_start), t=t, l_blk=l_blk,
                      pass_tiles=pass_tiles, epilogue=epilogue)


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              window: Optional[int] = None, blk: int = 128) -> torch.Tensor:
    """Causal / sliding-window GQA flash attention
    (kernels/flash_attention.py).  q: (B, H, S, D); k, v: (B, Hkv, S, D).
    Inputs that require grad (with grad enabled) raise ValueError: the
    kernel has no backward."""
    return flash_attention(q, k, v, window=window, blk_q=blk, blk_k=blk)


__all__ = ["pcc_tiles", "flash_mha", "EpilogueSpec"]
