"""Causal and sliding-window GQA flash attention, forward: the wrapper of the
CUDA kernel and its plain versions.

Port of ``repro/kernels/flash_attention.py`` (``flash_attention``, body
``_attn_kernel``, and ``grid_savings``) and of the oracle
``repro/kernels/ref.py::mha_ref``.

``flash_attention(q, k, v)`` computes, for every batch b and head h,
``softmax(q k^T / sqrt(D), masked) v`` with KV head ``h // (H / Hkv)``; q is
(B, H, S, D), k and v are (B, Hkv, S, D).  Query row i sees key j iff
``j <= i`` and, with a ``window``, ``j > i - window``.  The softmax runs in
float32 and the output row is ``acc / max(l, 1e-30)`` in ``q.dtype``.

The reference kernel drops the window whenever ``window // blk + 1`` key
blocks cover the whole triangle (``flash_attention.py:153-155``), so for
``(m_blocks - 1) * blk <= window < S`` it computes full causal attention,
against its own oracle.  The port keeps the window mask whenever one is
given, as ``mha_ref`` does; ``blk`` only validates the window.

Dispatch is by the tensors' device, then dtype: CUDA tensors launch a
hand-written kernel or raise, float32 the SIMT kernel of
``csrc/flash_attention.cu`` (IEEE float32 products), bf16 and fp16 the
tensor-core kernel of ``csrc/flash_attention_sm90.cu`` (wgmma with float32
accumulation, K and V staged by TMA; P rounded to the input type before
P V, so it agrees with the plain version within a gate scaled to each
output row, tighter than the reference's bf16 bound 3e-2, not bitwise).  CPU tensors run :func:`flash_attention_plain`, the
plain PyTorch version of the same function, which is also the kernels'
reference on the card.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.core.mapping import band_lower_count, tri_count

DEFAULT_BLK_Q = 128
DEFAULT_BLK_K = 128
# The reference's mask value: finite, so a row whose keys in a block are all
# masked keeps a finite running max.
NEG_INF = -1e30
# The kernels' widest head tile.
MAX_HEAD_DIM = 256
# Operand dtypes -> (kernel library, C entry point): float32 on the SIMT
# kernel, the 16-bit types on the tensor-core kernel.
ATTN_DTYPES = {
    torch.float32: ("flash_attention", "flash_attention_f32"),
    torch.bfloat16: ("flash_attention_sm90", "flash_attention_sm90_bf16"),
    torch.float16: ("flash_attention_sm90", "flash_attention_sm90_f16"),
}
# The tensor-core kernel's TMA reads rows whose stride is a multiple of 16
# bytes: 8 values of 16 bits.
HEAD_DIM_MULTIPLE = 8


def pad_head_dim(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """q, k, v with the head dimension zero-padded to the next multiple of
    HEAD_DIM_MULTIPLE, one copy each; the tensors themselves when D already
    is one.  Zero columns add exact zeros to every logit and give zero
    output columns, so slicing the first D columns of the padded result,
    computed with the scale 1 / sqrt(D) of the true D, changes no value."""
    pad = -q.shape[-1] % HEAD_DIM_MULTIPLE
    if pad == 0:
        return q, k, v
    return tuple(torch.nn.functional.pad(a, (0, pad)) for a in (q, k, v))


def _check(q, k, v, window, blk_q, blk_k):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k and v must be (B, H, S, D) and (B, Hkv, S, D)")
    b, h, s, d = q.shape
    hkv = k.shape[1]
    if tuple(k.shape) != (b, hkv, s, d) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k and v must be (B, Hkv, S, D) = (B={b}, Hkv, "
                         f"S={s}, D={d}), got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    if hkv == 0 or h % hkv:
        raise ValueError(f"H={h} not a multiple of Hkv={hkv}")
    if blk_q != blk_k:
        raise ValueError("triangular grid requires blk_q == blk_k")
    if window is not None and window % blk_k:
        raise ValueError(f"window={window} must be a multiple of "
                         f"blk_k={blk_k}")
    if q.dtype not in ATTN_DTYPES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise ValueError(f"q, k and v must share one of the dtypes "
                         f"{[str(t) for t in ATTN_DTYPES]}, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} exceeds the kernel's {MAX_HEAD_DIM}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one device")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: Optional[int] = None,
                    blk_q: int = DEFAULT_BLK_Q,
                    blk_k: int = DEFAULT_BLK_K) -> torch.Tensor:
    """Causal (optionally sliding-window) flash attention.

    q: (B, H, S, D); k, v: (B, Hkv, S, D), H % Hkv == 0, one dtype of
    float32, bfloat16 or float16, D <= MAX_HEAD_DIM.  Returns (B, H, S, D)
    in q.dtype.  window (in tokens) must be a multiple of blk_k when given;
    blk_q == blk_k as in the reference, where they size the job grid.  The
    CUDA kernels' own blocks are theirs (64 query rows in float32, 128 in
    bf16 / fp16), and S need not be a multiple of any block.
    ``flash_attention.launches`` counts the CUDA kernels' launches,
    ``flash_attention.launches_by_dtype`` per dtype.

    The kernels have no backward (neither has the reference's), so inputs
    that autograd records raise ValueError on both devices rather than
    hand back an output cut from the graph: training attention takes the
    plain route (``models/layers.self_attention``).
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise ValueError(
            "flash attention has no backward: call it under "
            "torch.no_grad() or on tensors that do not require grad")
    _check(q, k, v, window, blk_q, blk_k)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, window=window)
    from repro_torch.kernels import _build

    b, h, s, d = q.shape
    if q.numel() == 0:
        return torch.empty_like(q)
    name, entry = ATTN_DTYPES[q.dtype]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if q.dtype != torch.float32:
        q, k, v = pad_head_dim(q, k, v)
    out = torch.empty_like(q)
    lib = _build.load(name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, entry)(
            ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
            ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            b, h, k.shape[1], s, q.shape[-1], int(window is not None),
            0 if window is None else window, 1.0 / math.sqrt(d),
            ctypes.c_void_p(stream))
    if err != 0:
        msg = getattr(lib, name + "_error_string")(err).decode()
        raise RuntimeError(f"{entry} launch failed: {msg}")
    if out.shape[-1] != d:
        out = out[..., :d].contiguous()
    flash_attention.launches += 1
    flash_attention.launches_by_dtype[str(q.dtype).removeprefix("torch.")] \
        += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_dtype = {str(t).removeprefix("torch."): 0
                                     for t in ATTN_DTYPES}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, window: Optional[int] = None,
                          chunk: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_attention`'s function, on any
    device: causal, Sq == Sk, q scaled in float32 before the dot, masked
    logits at NEG_INF and their weights at 0, every operand widened to
    float32, the weights kept in float32 for P V as in the reference's
    ``_attn_kernel``, output ``acc / max(l, 1e-30)`` in q.dtype.  On the card,
    callers keep ``torch.backends.cuda.matmul.allow_tf32 = False`` (the
    default).

    It holds the (B, H, rows, keys) logits at once: all S x S, or with
    ``chunk`` one block of query rows at a time against the keys those rows
    can see (from the window's first key to the block's last row), for
    sequences whose whole logits would not fit.
    """
    b, h, s, d = q.shape
    rep = h // k.shape[1]
    qf = q.float() * (1.0 / math.sqrt(d))
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    step = s if chunk is None else chunk
    for r0 in range(0, s, step):
        r1 = min(s, r0 + step)
        k0 = 0 if window is None else min(r0, max(0, r0 - window + 1))
        logits = qf[:, :, r0:r1] @ kf[:, :, k0:r1].transpose(-1, -2)
        qpos = torch.arange(r0, r1, device=q.device)[:, None]
        kpos = torch.arange(k0, r1, device=q.device)[None, :]
        mask = kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        logits = logits.masked_fill_(~mask, NEG_INF)
        p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        p = p.masked_fill_(~mask, 0.0)
        l = p.sum(dim=-1, keepdim=True)
        out[:, :, r0:r1] = ((p @ vf[:, :, k0:r1]) / l.clamp_min(1e-30)).to(
            q.dtype)
    return out


def mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              scale: Optional[float] = None) -> torch.Tensor:
    """Multi-head attention oracle, ``repro/kernels/ref.py::mha_ref`` in
    torch.

    q: (B, H, Sq, D); k, v: (B, Hkv, Sk, D) with H % Hkv == 0 (GQA).  Query
    i is right-aligned to key position i + Sk - Sq (decode), sees key j iff
    j <= that position (causal) and j > it - window (window).  Logits are
    scaled after the dot; fully masked rows give zeros.  Computes in
    float32, or in float64 for float64 inputs.
    """
    b, h, sq, d = q.shape
    sk = k.shape[2]
    rep = h // k.shape[1]
    work = torch.float64 if q.dtype == torch.float64 else torch.float32
    kf = k.to(work).repeat_interleave(rep, dim=1)
    vf = v.to(work).repeat_interleave(rep, dim=1)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = (q.to(work) @ kf.transpose(-1, -2)) * scale
    qi = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    kj = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
    if window is not None:
        mask &= kj > qi - window
    p = torch.softmax(logits.masked_fill_(~mask, -math.inf), dim=-1)
    p = torch.nan_to_num(p, nan=0.0)
    return (p @ vf).to(q.dtype)


def grid_savings(s: int, blk: int, window: Optional[int] = None) -> float:
    """Fraction of the dense (m x m block) job grid that the reference's
    triangular or banded grid skips (m = ceil(s / blk)), as the reference
    computes it for its benchmarks."""
    m = -(-s // blk)
    dense = m * m
    if window is None or window // blk + 1 >= m:
        used = tri_count(m)
    else:
        used = band_lower_count(m, window // blk + 1)
    return 1.0 - used / dense


__all__ = ["flash_attention", "flash_attention_plain", "mha_plain",
           "grid_savings", "pad_head_dim", "NEG_INF", "MAX_HEAD_DIM",
           "ATTN_DTYPES"]
