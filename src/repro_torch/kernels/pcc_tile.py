"""All-pairs correlation tiles and their per-row top-k: wrappers and plain
versions.

Port of ``repro/kernels/pcc_tile.py`` in every mode, the replica axis of
significance runs included, with float32, bfloat16, float16, int8 or fp8
(``float8_e4m3fn``, ``float8_e5m2``) operands (both operands of one
dtype).  float32 operands take IEEE float32 FMA chains (the SIMT kernel,
kernels/csrc/pcc_tile.cu); bfloat16, float16, fp8 and int8 operands take
the tensor cores (kernels/csrc/pcc_tile_sm90.cu: wgmma with float32
accumulation, fp8 partial sums promoted to float32 every 128 samples, int8
one exact int32 sum converted to float32 once).  int8 tiles are bitwise
the plain version's; bfloat16, float16 and fp8 tiles lie within the narrow
gate of the plain version's (kernels/narrow_gate.py), not bitwise on
them.  Quantized
operands (core/quantize.py) bring per-row scales: the finished tile is
multiplied by the scale product ``row_scale[y] * col_scale[x]`` before the
epilogue.

``pcc_tiles`` (Pallas body ``_kernel``): ``pass_tiles`` consecutive (t, t)
tiles from the runtime tile id ``j_start``.  On the triangle (``grid_cols``
None) each id is inverted to its (y, x) upper-triangle coordinate and the
tile is U U^T, or U V^T with columns from a second operand ``v_pad`` of
U's exact shape (the masked measures' cross components); on the
rectangular grid (``grid_cols`` an int) ids number the m x grid_cols grid
row-major and the tile is U V^T with columns from ``v_pad``.  Each tile
accumulates over the whole sample axis in float32, then the scale
product (if any) and the fused :class:`EpilogueSpec` (x 1/div, then clip)
run before the single store.  Ids past the end clamp to the last tile.
A 3-D ``v_pad`` of shape (R, cols_pad, l_pad) is a replica stack (the
significance workload, core/significance.py): replica r's tiles are those
of the 2-D launch with ``v_pad = stack[r]`` and ``col_scale[r]``, bit for
bit, returned as (R, pass_tiles, t, t).

``pcc_topk_tiles`` (Pallas bodies ``_topk_kernel``/``_topk_select``): the
same tiles, folded into per-row (value, column) top-kk state under the
canonical order (|v| descending, then column ascending) instead of being
returned; triangles also rank the transposed off-diagonal tiles into a
mirrored column state.  It takes unscaled float32, bfloat16, float16 or int8
operands, and no second operand on the triangle.

Dispatch is by the operand's device: a CUDA tensor launches the CUDA kernels
(kernels/csrc/pcc_tile.cu or pcc_tile_sm90.cu by operand dtype,
kernels/csrc/pcc_topk.cu) or raises; a CPU tensor runs the plain version
(:func:`pcc_tiles_plain`, :func:`pcc_topk_tiles_plain`), a direct PyTorch
transcription of the same semantics that is also the kernels' reference on
the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.mapping import grid_job_coord_batch, job_coord_batch

DEFAULT_TILE = 256
DEFAULT_LBLK = 512
# The top-k select's quarter block, whose lines' partial lists its scratch
# holds, and the top-k state capacity the kernels take (csrc/pcc_topk.cu
# BM, KK_MAX).
CTA_BLOCK = 64
KK_MAX = 256
# Operand dtypes the tile kernel takes -> suffix of its C entry points; the
# top-k kernel takes the first three.
OPERAND_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16",
                  torch.float16: "f16", torch.int8: "i8",
                  torch.float8_e4m3fn: "e4m3", torch.float8_e5m2: "e5m2"}
TOPK_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int8)
_FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)
# Operand dtypes of the tensor-core tile kernel (csrc/pcc_tile_sm90.cu) and
# of the tensor-core select (the bf16, fp16 and int8 selects of
# csrc/pcc_topk.cu); float32 takes the SIMT kernels.
SM90_DTYPES = (torch.bfloat16, torch.float16, torch.int8) + _FP8
SELECT_SM90_DTYPES = (torch.bfloat16, torch.float16, torch.int8)
# TMA reads rows whose byte stride and base are multiples of this.
TMA_ALIGN = 16
# int8 sums of l_pad products of magnitude <= 128^2 stay inside int32.
INT8_MAX_L_PAD = (2**31 - 1) // 128**2
# Replicas of one launch: the CUDA grid's z extent.
MAX_REPLICAS = 65_535


def dtype_name(dtype) -> str:
    """The numpy-style name ("float32", "bfloat16", "int8", ...) of a torch
    dtype, a numpy dtype or a name."""
    if isinstance(dtype, str):
        return dtype
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return str(getattr(dtype, "name", dtype))


def _dtype_counts(dtypes=tuple(OPERAND_DTYPES)) -> dict:
    """A launch count per operand dtype, keyed by its name."""
    return {dtype_name(d): 0 for d in dtypes}


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
           pass_tiles: int, v_pad: Optional[torch.Tensor] = None,
           grid_cols: Optional[int] = None
           ) -> Tuple[int, int, torch.Tensor]:
    """Validate a launch; returns (m, total, column operand)."""
    if not isinstance(u_pad, torch.Tensor) or u_pad.ndim != 2:
        raise ValueError("u_pad must be a 2-D torch tensor")
    if u_pad.device.type not in ("cuda", "cpu"):
        raise ValueError(f"u_pad on unsupported device {u_pad.device}")
    if u_pad.dtype not in OPERAND_DTYPES:
        raise ValueError(f"u_pad must be float32, bfloat16, float16 or "
                         f"int8, or float8_e4m3fn / float8_e5m2, got "
                         f"{u_pad.dtype}")
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
    if u_pad.dtype == torch.int8 and l_pad > INT8_MAX_L_PAD:
        raise ValueError(f"int8 operands with l_pad={l_pad} > "
                         f"{INT8_MAX_L_PAD} could overflow the int32 sums")
    m = n_pad // t
    if grid_cols is None and v_pad is None:
        return m, m * (m + 1) // 2, u_pad
    if grid_cols is not None and v_pad is None:
        raise NotImplementedError(
            "the grid of U against itself (the reference's symmetric_grid "
            "mode) is not ported: pass v_pad with grid_cols")
    v = v_pad
    if not isinstance(v, torch.Tensor) or v.ndim not in (2, 3):
        raise ValueError("v_pad must be a 2-D torch tensor, or a 3-D "
                         "replica stack (R, cols_pad, l_pad)")
    if v.device != u_pad.device or v.dtype != u_pad.dtype or \
            not v.is_contiguous():
        raise ValueError(f"v_pad must be a contiguous tensor of u_pad's dtype "
                         f"({u_pad.dtype}) on {u_pad.device}, got {v.dtype} "
                         f"on {v.device}")
    if v.ndim == 3 and not 0 < v.shape[0] <= MAX_REPLICAS:
        raise ValueError(f"a replica stack holds 1 to {MAX_REPLICAS} "
                         f"replicas, got {v.shape[0]}")
    if grid_cols is None:
        if v.shape[-2:] != u_pad.shape:
            raise ValueError(
                f"a second operand may ride the triangular bijection only "
                f"when it (each replica of a stack) matches u_pad exactly "
                f"(symmetric composite GEMMs, permutation replicas), got "
                f"v_pad {tuple(v.shape)} vs u_pad {tuple(u_pad.shape)}")
        return m, m * (m + 1) // 2, v
    if grid_cols <= 0 or v.shape[-1] != l_pad or v.shape[-2] != grid_cols * t:
        raise ValueError(
            f"column operand {tuple(v.shape)} does not match grid_cols="
            f"{grid_cols} tiles of t={t} over l_pad={l_pad}")
    return m, m * grid_cols, v


def _check_scales(u_pad: torch.Tensor, v: torch.Tensor,
                  row_scale: Optional[torch.Tensor],
                  col_scale: Optional[torch.Tensor]) -> bool:
    """Validate the per-row dequantization scales; returns whether the
    launch is scaled."""
    if (row_scale is None) != (col_scale is None):
        raise ValueError("row_scale and col_scale must be given together "
                         "(pass the same scales twice for symmetric runs)")
    if row_scale is None:
        return False
    for name, s, shape in (("row_scale", row_scale, u_pad.shape[:1]),
                           ("col_scale", col_scale, v.shape[:-1])):
        # a replica stack's (R, cols_pad) scales may repeat one vector
        # (stride 0 over R): only the rows must be contiguous
        if not isinstance(s, torch.Tensor) or s.shape != shape or \
                s.dtype != torch.float32 or s.device != u_pad.device or \
                s.stride(-1) != 1:
            raise ValueError(
                f"{name} must be a {tuple(shape)} float32 tensor with "
                f"contiguous rows on {u_pad.device}, got "
                f"{getattr(s, 'dtype', type(s))} {tuple(getattr(s, 'shape', ()))}")
    return True


def _coords(m: int, grid_cols: Optional[int], ids: np.ndarray):
    if grid_cols is None:
        return job_coord_batch(m, ids)
    return grid_job_coord_batch(m, grid_cols, ids)


def _launch_error(lib, err: int, what: str, prefix: str) -> None:
    if err != 0:
        msg = getattr(lib, f"{prefix}_error_string")(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg}")


def tma_operand(x: torch.Tensor, l_blk: int) -> torch.Tensor:
    """`x`, a contiguous operand (rows, l_pad) or replica stack (R, rows,
    l_pad), as the tensor-core kernels read it: itself when its rows start
    on TMA_ALIGN-byte boundaries, else a copy with the sample axis
    zero-padded to a multiple of lcm(l_blk, TMA_ALIGN / itemsize).  Zero
    samples add exactly zero to every product, and the copy is still an
    operand of block l_blk, so tiles do not change."""
    per = TMA_ALIGN // x.element_size()
    width = x.shape[-1]
    if width % per == 0 and x.data_ptr() % TMA_ALIGN == 0:
        return x
    step = math.lcm(l_blk, per)
    out = torch.zeros(*x.shape[:-1], -(-width // step) * step,
                      dtype=x.dtype, device=x.device)
    # fp8 copies move as bytes (copy kernels need not take fp8 types)
    raw = torch.uint8 if x.dtype in _FP8 else x.dtype
    out.view(raw)[..., :width] = x.view(raw)
    return out


def tile_kernel(dtype: torch.dtype) -> Tuple[str, str]:
    """(kernel library, C entry point) of :func:`pcc_tiles` for operands of
    `dtype`: pcc_tile / pcc_tiles_f32 (SIMT) for float32, pcc_tile_sm90 /
    pcc_tiles_sm90_{bf16,f16,e4m3,e5m2,i8} (tensor cores) for the others."""
    if dtype in SM90_DTYPES:
        return "pcc_tile_sm90", "pcc_tiles_sm90_" + OPERAND_DTYPES[dtype]
    return "pcc_tile", "pcc_tiles_" + OPERAND_DTYPES[dtype]


def _kernel_operands(u_pad: torch.Tensor, v: torch.Tensor, l_blk: int,
                     sm90_dtypes=SM90_DTYPES):
    """(u, v) as the CUDA kernel of their dtype reads them: through
    :func:`tma_operand` for the tensor-core kernels (`sm90_dtypes`), as
    they are for the SIMT ones; v stays u where it is u (the triangle)."""
    if u_pad.dtype not in sm90_dtypes:
        return u_pad, v
    u_k = tma_operand(u_pad, l_blk)
    return u_k, (u_k if v is u_pad else tma_operand(v, l_blk))


def pcc_tiles(u_pad: torch.Tensor, j_start: int, *, t: int = DEFAULT_TILE,
              l_blk: int = DEFAULT_LBLK, pass_tiles: int,
              epilogue: Optional[EpilogueSpec] = None,
              v_pad: Optional[torch.Tensor] = None,
              grid_cols: Optional[int] = None,
              row_scale: Optional[torch.Tensor] = None,
              col_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Compute `pass_tiles` consecutive tiles from tile id `j_start`.

    u_pad: (n_pad, l_pad) transformed variables (Eq. 4), zero-padded so
           n_pad % t == 0 and l_pad % l_blk == 0, contiguous; float32,
           bfloat16, float16, int8 (l_pad <= INT8_MAX_L_PAD), float8_e4m3fn or
           float8_e5m2.
    epilogue: optional EpilogueSpec applied before the store.
    v_pad / grid_cols: grid_cols=None runs the triangle, columns from U or
           from a v_pad of U's exact shape and dtype; an int selects the
           rectangular grid, rows from U and columns from v_pad
           (grid_cols * t, l_pad), which the grid requires.  A 3-D v_pad
           (R, ., l_pad) stacks R such column operands (the replica axis;
           1 <= R <= MAX_REPLICAS).
    row_scale / col_scale: optional (n_pad,) and (column rows,) float32
           per-row dequantization scales of quantized operands, given
           together; each finished tile is multiplied by
           row_scale[y] * col_scale[x] (the product first) before the
           epilogue.  A replica stack takes col_scale (R, column rows),
           whose replica stride may be 0 (one vector expanded over R).
    Returns (pass_tiles, t, t) float32, or (R, pass_tiles, t, t) for a
    replica stack.  ``pcc_tiles.launches`` counts the CUDA kernel's
    launches, ``pcc_tiles.launches_by_dtype`` per operand dtype,
    ``pcc_tiles.scaled_launches`` those with scales,
    ``pcc_tiles.triangle_pair_launches`` those on the triangle with a 2-D
    second operand, ``pcc_tiles.replica_launches`` those with a replica
    stack and ``pcc_tiles.replicas_launched`` the sum of their R.
    """
    j_start = int(j_start)
    m, _, v = _check(u_pad, j_start, t, l_blk, pass_tiles, v_pad, grid_cols)
    scaled = _check_scales(u_pad, v, row_scale, col_scale)
    replicas = v.shape[0] if v.ndim == 3 else 0
    if u_pad.device.type == "cpu":
        return pcc_tiles_plain(u_pad, j_start, t=t, l_blk=l_blk,
                               pass_tiles=pass_tiles, epilogue=epilogue,
                               v_pad=v_pad, grid_cols=grid_cols,
                               row_scale=row_scale, col_scale=col_scale)
    from repro_torch.kernels import _build

    u_k, v_k = _kernel_operands(u_pad, v, l_blk)
    name, entry = tile_kernel(u_pad.dtype)
    lib = _build.load(name)
    spec = epilogue if epilogue is not None else EpilogueSpec()
    out = torch.empty((replicas, pass_tiles, t, t) if replicas
                      else (pass_tiles, t, t), dtype=torch.float32,
                      device=u_pad.device)
    # element strides between replicas of the stack and of its scales
    v_rstride = v_k.stride(0) if replicas else 0
    s_rstride = col_scale.stride(0) if replicas and scaled else 0
    with torch.cuda.device(u_pad.device):
        stream = torch.cuda.current_stream(u_pad.device).cuda_stream
        err = getattr(lib, entry)(
            ctypes.c_void_p(u_k.data_ptr()), ctypes.c_void_p(v_k.data_ptr()),
            *_ptrs([row_scale, col_scale] if scaled else [], 2),
            ctypes.c_void_p(out.data_ptr()), j_start, pass_tiles, m,
            grid_cols or 0, t, u_k.shape[1], replicas, v_rstride,
            s_rstride, *spec.kernel_args(), ctypes.c_void_p(stream))
    _launch_error(lib, err, "pcc_tiles", name)
    pcc_tiles.launches += 1
    pcc_tiles.launches_by_dtype[dtype_name(u_pad.dtype)] += 1
    pcc_tiles.scaled_launches += int(scaled)
    pcc_tiles.triangle_pair_launches += int(grid_cols is None
                                            and v_pad is not None
                                            and not replicas)
    pcc_tiles.replica_launches += int(replicas > 0)
    pcc_tiles.replicas_launched += replicas
    return out


pcc_tiles.launches = 0
pcc_tiles.launches_by_dtype = _dtype_counts()
pcc_tiles.scaled_launches = 0
pcc_tiles.triangle_pair_launches = 0
pcc_tiles.replica_launches = 0
pcc_tiles.replicas_launched = 0


def pcc_tiles_plain(u_pad: torch.Tensor, j_start: int, *,
                    t: int = DEFAULT_TILE, l_blk: int = DEFAULT_LBLK,
                    pass_tiles: int,
                    epilogue: Optional[EpilogueSpec] = None,
                    v_pad: Optional[torch.Tensor] = None,
                    grid_cols: Optional[int] = None,
                    row_scale: Optional[torch.Tensor] = None,
                    col_scale: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Plain PyTorch version of :func:`pcc_tiles`, on any device.

    Transcribes the Pallas grid: tile ids invert on the host with the exact
    ``job_coord_batch`` (or the grid's division), each (t, l_blk) row and
    column block pair adds its float32 product into the tile, then the
    scale product and the epilogue run.  On the card, callers set
    ``torch.backends.cuda.matmul.allow_tf32 = False`` (the default) so the
    products stay IEEE float32.

    bfloat16, float16 and fp8 operands widen to float32 first (exactly).  int8
    operands widen to float64, where every integer sum up to 2^53 is exact
    in any order, and round once to float32: bitwise the kernel's int32 sum
    converted.  Scales multiply as ``tile * (row_scale[y] * col_scale[x])``
    in float32, as the kernel does.  A replica stack runs the 2-D version
    once per replica, so replica r's tiles are bitwise those of
    ``v_pad = stack[r]``, ``col_scale = col_scale[r]``.
    """
    j_start = int(j_start)
    m, total, v = _check(u_pad, j_start, t, l_blk, pass_tiles, v_pad,
                         grid_cols)
    scaled = _check_scales(u_pad, v, row_scale, col_scale)
    if v.ndim == 3:
        out = torch.empty((v.shape[0], pass_tiles, t, t),
                          dtype=torch.float32, device=u_pad.device)
        for r in range(v.shape[0]):
            out[r] = pcc_tiles_plain(
                u_pad, j_start, t=t, l_blk=l_blk, pass_tiles=pass_tiles,
                epilogue=epilogue, v_pad=v[r], grid_cols=grid_cols,
                row_scale=row_scale,
                col_scale=col_scale[r] if scaled else None)
        return out
    ids = np.minimum(j_start + np.arange(pass_tiles, dtype=np.int64),
                     total - 1)
    ys, xs = _coords(m, grid_cols, ids)
    dev = u_pad.device
    ys = torch.as_tensor(ys, device=dev)
    xs = torch.as_tensor(xs, device=dev)
    l_pad = u_pad.shape[1]
    wide = torch.float64 if u_pad.dtype == torch.int8 else torch.float32
    # fp8 blocks are gathered as their bytes (indexing kernels need not
    # take fp8 types), then viewed back and widened
    raw = torch.uint8 if u_pad.dtype in _FP8 else u_pad.dtype
    u3 = u_pad.view(raw).view(m, t, l_pad)
    v3 = v.view(raw).view(v.shape[0] // t, t, l_pad)
    acc = torch.zeros((pass_tiles, t, t), dtype=wide, device=dev)
    for k0 in range(0, l_pad, l_blk):
        rows = u3[ys, :, k0:k0 + l_blk].view(u_pad.dtype).to(wide)
        cols = v3[xs, :, k0:k0 + l_blk].view(u_pad.dtype).to(wide)
        acc += torch.bmm(rows, cols.transpose(1, 2))
    acc = acc.to(torch.float32)
    if scaled:
        srow = row_scale.view(m, t)[ys]
        scol = col_scale.view(-1, t)[xs]
        acc = acc * (srow[:, :, None] * scol[:, None, :])
    if epilogue is not None and not epilogue.is_identity():
        acc = epilogue.apply(acc)
    return acc


def _check_topk(u_pad: torch.Tensor, j_start: int, t: int, l_blk: int,
                pass_tiles: int, v_pad: Optional[torch.Tensor],
                grid_cols: Optional[int], kk: int, dev_hi: int,
                n_cols_valid: int) -> Tuple[int, int, torch.Tensor]:
    """Validate a top-k launch; returns (m, total, column operand)."""
    m, total, v = _check(u_pad, j_start, t, l_blk, pass_tiles, v_pad,
                         grid_cols)
    if v.ndim == 3:
        raise ValueError("pcc_topk_tiles takes no replica stack: "
                         "significance runs rank p-values through TopKSink")
    if u_pad.dtype not in TOPK_DTYPES:
        raise ValueError(f"pcc_topk_tiles takes float32, bfloat16, float16 "
                         f"or int8 operands, got {u_pad.dtype} (fp8 operands "
                         f"carry row scales, which the top-k kernel does not "
                         f"take)")
    if grid_cols is None and v_pad is not None:
        raise NotImplementedError(
            "pcc_topk_tiles takes no second operand on the triangle: the "
            "masked runs of ROADMAP slice 5 that pass one stream tiles "
            "(DeviceTopKSink refuses them), so no caller needs it")
    if not 0 < kk <= KK_MAX:
        raise ValueError(f"kk must be in [1, {KK_MAX}], got {kk}")
    if not 0 <= dev_hi <= total:
        raise ValueError(f"dev_hi must be in [0, total={total}], got "
                         f"{dev_hi}")
    if not 0 < n_cols_valid <= v.shape[0]:
        raise ValueError(f"n_cols_valid must be in [1, {v.shape[0]}], got "
                         f"{n_cols_valid}")
    return m, total, v


def topk_scratch_bytes(pass_tiles: int, t: int, kk: int,
                       mirror: bool) -> int:
    """Bytes of the pass scratch :func:`pcc_topk_tiles` allocates on the
    card: per side (rows; columns too on the triangle), a (value, column)
    pair for each of min(kk, 64) entries of each row of each 64-column
    block of each tile."""
    nb = -(-t // CTA_BLOCK)
    return (2 if mirror else 1) * pass_tiles * t * nb * min(kk, CTA_BLOCK) * 8


def pcc_topk_tiles(u_pad: torch.Tensor, j_start: int, dev_hi: int, *,
                   t: int = DEFAULT_TILE, l_blk: int = DEFAULT_LBLK,
                   pass_tiles: int, kk: int, n_cols_valid: int,
                   symmetric_problem: bool = True,
                   epilogue: Optional[EpilogueSpec] = None,
                   v_pad: Optional[torch.Tensor] = None,
                   grid_cols: Optional[int] = None):
    """pcc_tiles with the per-row top-k epilogue: the `pass_tiles` tiles
    from raw start `j_start` are folded into per-row-block top-kk state
    instead of being returned.

    dev_hi: exclusive tile bound (<= the workload's tile count); slots at
           or past it contribute nothing.
    kk: state capacity per row (1 <= kk <= KK_MAX); n_cols_valid masks
           padding columns; symmetric_problem also masks self-pairs.
    Returns (row_vals, row_cols) on the grid, plus (col_vals, col_cols) on
    the triangle, each (m, t, kk) (values float32, columns int32; empty
    slots hold value 0 and column -1).  ``pcc_topk_tiles.launches`` counts
    the launches of each of its two CUDA kernels,
    ``pcc_topk_tiles.select_by_dtype`` the select kernel's per operand
    dtype (the merge kernel reads float32 values whatever the operands).
    """
    j_start, dev_hi = int(j_start), int(dev_hi)
    args = dict(t=t, l_blk=l_blk, pass_tiles=pass_tiles, kk=kk,
                n_cols_valid=n_cols_valid,
                symmetric_problem=symmetric_problem, epilogue=epilogue,
                v_pad=v_pad, grid_cols=grid_cols)
    m, total, v = _check_topk(u_pad, j_start, t, l_blk, pass_tiles, v_pad,
                              grid_cols, kk, dev_hi, n_cols_valid)
    if u_pad.device.type == "cpu":
        return pcc_topk_tiles_plain(u_pad, j_start, dev_hi, **args)
    scratch = topk_select(u_pad, j_start, dev_hi, **args)
    return topk_merge(scratch, j_start, dev_hi, m=m, t=t,
                      pass_tiles=pass_tiles, kk=kk, grid_cols=grid_cols)


pcc_topk_tiles.launches = {"select": 0, "merge": 0}
pcc_topk_tiles.select_by_dtype = _dtype_counts(TOPK_DTYPES)


def _ptrs(tensors, count: int):
    flat = list(tensors) + [None] * (count - len(tensors))
    return [ctypes.c_void_p(0 if x is None else x.data_ptr()) for x in flat]


def topk_select(u_pad: torch.Tensor, j_start: int, dev_hi: int, *, t: int,
                l_blk: int, pass_tiles: int, kk: int, n_cols_valid: int,
                symmetric_problem: bool,
                epilogue: Optional[EpilogueSpec] = None,
                v_pad: Optional[torch.Tensor] = None,
                grid_cols: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
    """The first CUDA kernel of :func:`pcc_topk_tiles`: each tile line's
    top-min(kk, 64) per 64-wide block, into a pass scratch of (pass_tiles,
    t, ceil(t/64), min(kk, 64)) (value, column) pairs per side (rows;
    columns too on the triangle).  float32 operands take the SGEMM mainloop
    of the float32 tiles; bf16, fp16 and int8 operands the tensor-core mainloop
    of their tiles (csrc/pcc_mma.cuh), read through :func:`tma_operand`
    (int8's exact int32 sums converted once), so the values are bitwise
    :func:`pcc_tiles`'.  A CPU tensor runs :func:`topk_select_plain`."""
    m, total, v = _check_topk(u_pad, j_start, t, l_blk, pass_tiles, v_pad,
                              grid_cols, kk, dev_hi, n_cols_valid)
    if u_pad.device.type == "cpu":
        return topk_select_plain(
            u_pad, j_start, dev_hi, t=t, l_blk=l_blk, pass_tiles=pass_tiles,
            kk=kk, n_cols_valid=n_cols_valid,
            symmetric_problem=symmetric_problem, epilogue=epilogue,
            v_pad=v_pad, grid_cols=grid_cols)
    from repro_torch.kernels import _build

    lib = _build.load("pcc_topk")
    dev = u_pad.device
    spec = epilogue if epilogue is not None else EpilogueSpec()
    part = (pass_tiles, t, -(-t // CTA_BLOCK), min(kk, CTA_BLOCK))
    scratch = []
    for _side in range(1 if grid_cols is not None else 2):
        scratch += [torch.empty(part, dtype=torch.float32, device=dev),
                    torch.empty(part, dtype=torch.int32, device=dev)]
    u_k, v_k = _kernel_operands(u_pad, v, l_blk, SELECT_SM90_DTYPES)
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        fn = getattr(lib, "pcc_topk_select_" + OPERAND_DTYPES[u_pad.dtype])
        err = fn(
            ctypes.c_void_p(u_k.data_ptr()), ctypes.c_void_p(v_k.data_ptr()),
            *_ptrs(scratch, 4), j_start, dev_hi, pass_tiles, m,
            grid_cols or 0, t, u_k.shape[1], kk, n_cols_valid,
            int(symmetric_problem), *spec.kernel_args(), stream)
    _launch_error(lib, err, "pcc_topk_tiles (select)", "pcc_topk")
    pcc_topk_tiles.launches["select"] += 1
    pcc_topk_tiles.select_by_dtype[dtype_name(u_pad.dtype)] += 1
    return tuple(scratch)


def topk_merge(scratch: Tuple[torch.Tensor, ...], j_start: int, dev_hi: int,
               *, m: int, t: int, pass_tiles: int, kk: int,
               grid_cols: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
    """The second CUDA kernel of :func:`pcc_topk_tiles`: merge the pass
    scratch of :func:`topk_select` into the (m, t, kk) state outputs.  A
    scratch on the CPU runs :func:`topk_merge_plain`."""
    if scratch[0].device.type == "cpu":
        return topk_merge_plain(scratch, j_start, dev_hi, m=m, t=t,
                                pass_tiles=pass_tiles, kk=kk,
                                grid_cols=grid_cols)
    from repro_torch.kernels import _build

    lib = _build.load("pcc_topk")
    dev = scratch[0].device
    state = []
    for _side in range(len(scratch) // 2):
        state += [torch.empty((m, t, kk), dtype=torch.float32, device=dev),
                  torch.empty((m, t, kk), dtype=torch.int32, device=dev)]
    hi_eff = min(j_start + pass_tiles, dev_hi)
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        err = lib.pcc_topk_merge(*_ptrs(scratch, 4), *_ptrs(state, 4),
                                 j_start, hi_eff, m, grid_cols or 0, t, kk,
                                 stream)
    _launch_error(lib, err, "pcc_topk_tiles (merge)", "pcc_topk")
    pcc_topk_tiles.launches["merge"] += 1
    return tuple(state)


def topk_fold_states(states: Sequence[Tuple[torch.Tensor, torch.Tensor]]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold several (values, columns) states of one side, each (m, t, kk)
    on one device in canonical order (a mesh's rank states of one pass),
    into one, by :func:`topk_merge`: each state row is cut into lists of
    min(kk, 64) entries, a row's lists from every state are laid out as
    the pass scratch of a grid of ceil(lists / ceil(t / 64)) tiles a row
    block (masked lists pad the last), and the merge takes each row's
    top-kk of them all.  The states' candidates must be disjoint (tiles of
    different ranks), as the merge keeps duplicates.  Returns (values,
    columns), (m, t, kk), bitwise any canonical merge of the same
    candidates."""
    vals = torch.stack([v for v, _ in states], dim=2)      # (m, t, S, kk)
    cols = torch.stack([c for _, c in states], dim=2)
    m, t, n_states, kk = vals.shape
    kc = min(kk, CTA_BLOCK)
    nb = -(-t // CTA_BLOCK)
    lists = n_states * -(-kk // kc)
    q = -(-lists // nb)                                     # slots a block
    pad = (0, -(-kk // kc) * kc - kk)
    vals = F.pad(vals, pad).reshape(m, t, lists, kc)
    cols = F.pad(cols, pad, value=-1).reshape(m, t, lists, kc)
    pad = (0, 0, 0, q * nb - lists)
    scratch = tuple(
        F.pad(a, pad, value=fill).reshape(m, t, q, nb, kc)
        .transpose(1, 2).reshape(m * q, t, nb, kc).contiguous()
        for a, fill in ((vals, 0.0), (cols, -1)))
    return topk_merge(scratch, 0, m * q, m=m, t=t, pass_tiles=m * q, kk=kk,
                      grid_cols=q)


def _topk_select(cand_v: torch.Tensor, cand_c: torch.Tensor,
                 kk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rows of (t, c) candidates -> (t, kk) top-kk under the canonical
    order, as the reference's ``_topk_select`` folds a tile into empty
    state: masked candidates (column -1) carry value 0 and key -inf, and
    two stable sorts, secondary key (column) first, give the order."""
    t = cand_v.shape[0]
    dev = cand_v.device
    cand_v = torch.cat([torch.zeros((t, kk), dtype=torch.float32, device=dev),
                        torch.where(cand_c < 0, 0.0, cand_v)], dim=1)
    cand_c = torch.cat([torch.full((t, kk), -1, dtype=cand_c.dtype,
                                   device=dev), cand_c], dim=1)
    key = torch.where(cand_c < 0, -torch.inf, cand_v.abs())
    p1 = torch.argsort(cand_c, dim=1, stable=True)
    key1 = torch.take_along_dim(-key, p1, dim=1)
    p2 = torch.argsort(key1, dim=1, stable=True)
    sel = torch.take_along_dim(p1, p2, dim=1)[:, :kk]
    return (torch.take_along_dim(cand_v, sel, dim=1),
            torch.take_along_dim(cand_c, sel, dim=1).to(torch.int32))


def pcc_topk_tiles_plain(u_pad: torch.Tensor, j_start: int, dev_hi: int, *,
                         t: int = DEFAULT_TILE, l_blk: int = DEFAULT_LBLK,
                         pass_tiles: int, kk: int, n_cols_valid: int,
                         symmetric_problem: bool = True,
                         epilogue: Optional[EpilogueSpec] = None,
                         v_pad: Optional[torch.Tensor] = None,
                         grid_cols: Optional[int] = None):
    """Plain PyTorch version of :func:`pcc_topk_tiles`, on any device.

    The pass's valid slots (a prefix: j_start + i < dev_hi) are computed
    with :func:`pcc_tiles_plain`; each row block then takes the top-kk of
    all its candidates at once with :func:`_topk_select`.  The canonical
    order is total over a row's unique columns, so this equals the
    reference's tile-by-tile fold.
    """
    j_start, dev_hi = int(j_start), int(dev_hi)
    m, total, v = _check_topk(u_pad, j_start, t, l_blk, pass_tiles, v_pad,
                              grid_cols, kk, dev_hi, n_cols_valid)
    n_valid = min(pass_tiles, dev_hi - j_start)
    tiles = None
    if n_valid > 0:
        tiles = pcc_tiles_plain(u_pad, j_start, t=t, l_blk=l_blk,
                                pass_tiles=n_valid, epilogue=epilogue,
                                v_pad=v_pad, grid_cols=grid_cols)
    return topk_fold_plain(tiles, j_start, m=m, t=t, kk=kk,
                           n_cols_valid=n_cols_valid,
                           symmetric_problem=symmetric_problem,
                           grid_cols=grid_cols, device=u_pad.device)


def topk_fold_plain(tiles: Optional[torch.Tensor], j_start: int, *, m: int,
                    t: int, kk: int, n_cols_valid: int,
                    symmetric_problem: bool, grid_cols: Optional[int],
                    device) -> Tuple[torch.Tensor, ...]:
    """The ranking half of :func:`pcc_topk_tiles_plain`: fold the finished
    tiles of ids j_start, j_start + 1, ... (None for no valid slot) into the
    (m, t, kk) state outputs."""
    dev = torch.device(device)
    mirror = grid_cols is None
    state = [(torch.zeros((m, t, kk), dtype=torch.float32, device=dev),
              torch.full((m, t, kk), -1, dtype=torch.int32, device=dev))
             for _ in range(2 if mirror else 1)]
    if tiles is not None:
        ys, xs = _coords(m, grid_cols, j_start + np.arange(tiles.shape[0]))
        span = torch.arange(t, device=dev)
        for y in np.unique(ys):
            sel = torch.as_tensor(np.nonzero(ys == y)[0], device=dev)
            vals = tiles[sel].permute(1, 0, 2).reshape(t, -1)
            cols = (torch.as_tensor(xs, device=dev)[sel, None] * t
                    + span).reshape(1, -1).expand(t, -1)
            bad = cols >= n_cols_valid
            if symmetric_problem:
                bad = bad | (cols == int(y) * t + span[:, None])
            rv, rc = _topk_select(vals, torch.where(bad, -1, cols), kk)
            state[0][0][y], state[0][1][y] = rv, rc
        if mirror:
            off = ys != xs
            for x in np.unique(xs[off]):
                sel = torch.as_tensor(np.nonzero(off & (xs == x))[0],
                                      device=dev)
                vals = tiles[sel].permute(2, 0, 1).reshape(t, -1)
                cols = (torch.as_tensor(ys, device=dev)[sel, None] * t
                        + span).reshape(1, -1).expand(t, -1)
                cv, cc = _topk_select(
                    vals, torch.where(cols >= n_cols_valid, -1, cols), kk)
                state[1][0][x], state[1][1][x] = cv, cc
    return tuple(x for pair in state for x in pair)


def _block_lists(vals: torch.Tensor, cols: torch.Tensor,
                 kc: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n, t, t) line values and their candidates' columns (-1 masked) ->
    each line's top-kc per 64-candidate block, (n, t, nb, kc) each, the
    candidates past t masked."""
    n, t, _ = vals.shape
    nb = -(-t // CTA_BLOCK)
    pad = nb * CTA_BLOCK - t
    vals = torch.nn.functional.pad(vals, (0, pad))
    cols = torch.nn.functional.pad(cols, (0, pad), value=-1)
    lv, lc = _topk_select(vals.reshape(-1, CTA_BLOCK),
                          cols.reshape(-1, CTA_BLOCK), kc)
    return lv.view(n, t, nb, kc), lc.view(n, t, nb, kc)


def topk_select_plain(u_pad: torch.Tensor, j_start: int, dev_hi: int, *,
                      t: int, l_blk: int, pass_tiles: int, kk: int,
                      n_cols_valid: int, symmetric_problem: bool,
                      epilogue: Optional[EpilogueSpec] = None,
                      v_pad: Optional[torch.Tensor] = None,
                      grid_cols: Optional[int] = None
                      ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of :func:`topk_select`, on any device: the
    same pass scratch, from :func:`pcc_tiles_plain`'s tiles.  Each list
    (slot, line, 64-wide block) holds its line's top-min(kk, 64) of that
    block in canonical order, masked entries (value 0, column -1) last.
    Lists the merge never reads (slots at or past dev_hi; the column side
    of diagonal tiles) hold masked entries only; the kernel leaves them
    unwritten."""
    j_start, dev_hi = int(j_start), int(dev_hi)
    m, total, v = _check_topk(u_pad, j_start, t, l_blk, pass_tiles, v_pad,
                              grid_cols, kk, dev_hi, n_cols_valid)
    dev = u_pad.device
    kc = min(kk, CTA_BLOCK)
    part = (pass_tiles, t, -(-t // CTA_BLOCK), kc)
    sides = [[torch.zeros(part, dtype=torch.float32, device=dev),
              torch.full(part, -1, dtype=torch.int32, device=dev)]
             for _ in range(1 if grid_cols is not None else 2)]
    n_valid = min(pass_tiles, dev_hi - j_start)
    if n_valid <= 0:
        return tuple(x for side in sides for x in side)
    tiles = pcc_tiles_plain(u_pad, j_start, t=t, l_blk=l_blk,
                            pass_tiles=n_valid, epilogue=epilogue,
                            v_pad=v_pad, grid_cols=grid_cols)
    ys, xs = _coords(m, grid_cols, j_start + np.arange(n_valid))
    ys = torch.as_tensor(ys, device=dev)[:, None, None]
    xs = torch.as_tensor(xs, device=dev)[:, None, None]
    span = torch.arange(t, device=dev)
    # rows: line r of tile (y, x), candidates x*t + c
    cand = xs * t + span
    bad = cand >= n_cols_valid
    if symmetric_problem:
        bad = bad | (cand == ys * t + span[:, None])
    sides[0][0][:n_valid], sides[0][1][:n_valid] = _block_lists(
        tiles, torch.where(bad, -1, cand).expand(-1, t, -1), kc)
    if grid_cols is None:
        # columns: line c of off-diagonal tile (y, x), candidates y*t + r
        cand = ys * t + span
        bad = (cand >= n_cols_valid) | (ys == xs)
        sides[1][0][:n_valid], sides[1][1][:n_valid] = _block_lists(
            tiles.transpose(1, 2), torch.where(bad, -1, cand).expand(
                -1, t, -1), kc)
    return tuple(x for side in sides for x in side)


def topk_merge_plain(scratch: Tuple[torch.Tensor, ...], j_start: int,
                     dev_hi: int, *, m: int, t: int, pass_tiles: int,
                     kk: int, grid_cols: Optional[int] = None
                     ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of :func:`topk_merge`, on any device: each
    output row takes the top-kk under the canonical order of the lists
    that the pass's valid slots hold for it (row block y: the tiles (y, x);
    its mirrored column state: the off-diagonal tiles (x, y)), empty slots
    value 0 and column -1.  Only the values and columns of the scratch are
    moved, so the state is bitwise whatever merges the same lists."""
    j_start, dev_hi = int(j_start), int(dev_hi)
    dev = scratch[0].device
    state = []
    n_valid = min(pass_tiles, dev_hi - j_start)
    ys, xs = _coords(m, grid_cols, j_start + np.arange(max(n_valid, 0)))
    for side in range(len(scratch) // 2):
        pv, pc = scratch[2 * side], scratch[2 * side + 1]
        vals = torch.zeros((m, t, kk), dtype=torch.float32, device=dev)
        cols = torch.full((m, t, kk), -1, dtype=torch.int32, device=dev)
        owner = ys if side == 0 else xs
        read = np.ones(len(ys), bool) if side == 0 else ys != xs
        for y in np.unique(owner[read]):
            sel = torch.as_tensor(np.nonzero(read & (owner == y))[0],
                                  device=dev)
            vals[y], cols[y] = _topk_select(
                pv[sel].transpose(0, 1).reshape(t, -1),
                pc[sel].transpose(0, 1).reshape(t, -1), kk)
        state += [vals, cols]
    return tuple(state)


__all__ = ["DEFAULT_TILE", "DEFAULT_LBLK", "CTA_BLOCK", "KK_MAX",
           "OPERAND_DTYPES", "TOPK_DTYPES", "SM90_DTYPES",
           "SELECT_SM90_DTYPES", "TMA_ALIGN",
           "INT8_MAX_L_PAD", "MAX_REPLICAS", "dtype_name", "tma_operand",
           "tile_kernel",
           "EpilogueSpec", "pcc_tiles", "pcc_tiles_plain", "pcc_topk_tiles",
           "pcc_topk_tiles_plain", "topk_select", "topk_merge",
           "topk_select_plain", "topk_merge_plain", "topk_fold_plain",
           "topk_fold_states", "topk_scratch_bytes"]
