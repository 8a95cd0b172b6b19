"""Gradient compression for data-parallel synchronisation.

Port of ``repro/optim/compression.py``: int8 quantisation (per-tensor
absmax scaling, ~4x fewer wire bytes), top-k sparsification, and the int8
all-reduce with error feedback (Seide et al. / EF-SGD: each rank keeps its
quantisation residual and adds it to the next step's gradient).

The reference runs ``compressed_psum`` inside ``shard_map``, one call a
rank, and reduces over a named mesh axis.  One process drives every rank
here (launch/mesh.py), so the functions take the data axis's per-rank
tensors in rank order: ``pmax`` is a max over the ranks' absmax values,
``psum`` an int32 sum over the ranks' int8 payloads, brought to each rank's
device.  Every rank gets the same bits, and each one's are the reference's
for the same per-rank inputs.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

Tensor = torch.Tensor


def quantize_int8(x: Tensor) -> Tuple[Tensor, Tensor]:
    absmax = torch.max(torch.abs(x)) + 1e-12
    scale = absmax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: Tensor, scale: Tensor) -> Tensor:
    return q.to(torch.float32) * scale


def topk_sparsify(x: Tensor, frac: float) -> Tensor:
    """Zero all but the top `frac` fraction of entries (by magnitude)."""
    flat = x.reshape(-1)
    k = max(1, int(flat.shape[0] * frac))
    thresh = torch.topk(torch.abs(flat), k).values[-1]
    return torch.where(torch.abs(x) >= thresh, x, torch.zeros_like(x))


def compressed_psum(grads: Sequence[Tensor], errors: Sequence[Tensor]
                    ) -> Tuple[List[Tensor], List[Tensor]]:
    """int8 all-reduce with error feedback over the ranks of a data axis.

    grads[r], errors[r]: rank r's gradient and residual (on its device).
    Returns (averaged float32 gradient of each rank, new residual of each
    rank).  The ranks agree on one scale (the max of their absmax values)
    so the int8 payloads are commensurable; the payloads are summed in
    int32 (no overflow across ranks); each rank's dequantisation error is
    its residual for the next step.
    """
    if len(grads) != len(errors) or not grads:
        raise ValueError(f"{len(grads)} gradients for {len(errors)} "
                         f"residuals")
    home = grads[0].device
    gs = [g.to(torch.float32) + e for g, e in zip(grads, errors)]
    absmax = torch.stack([(torch.max(torch.abs(g)) + 1e-12).to(home)
                          for g in gs])
    scale = torch.max(absmax) / 127.0
    qs, new_errors = [], []
    for g in gs:
        s = scale.to(g.device)
        q = torch.clamp(torch.round(g / s), -127, 127).to(torch.int8)
        new_errors.append(g - q.to(torch.float32) * s)
        qs.append(q)
    total = qs[0].to(torch.int32)
    for q in qs[1:]:
        total = total + q.to(device=home, dtype=torch.int32)
    n = float(len(gs))
    avg = total.to(torch.float32) * scale / n
    return [avg.to(g.device, copy=g.device == home and i > 0)
            for i, g in enumerate(gs)], new_errors


def compress_tree_psum(grads: Sequence[Sequence[Tensor]],
                       errors: Sequence[Sequence[Tensor]]):
    """``compressed_psum`` leaf by leaf: grads[r] and errors[r] are rank
    r's leaves in one order.  Returns (averaged leaves of each rank, new
    residuals of each rank)."""
    n_ranks = len(grads)
    avgs: List[List[Tensor]] = [[] for _ in range(n_ranks)]
    errs: List[List[Tensor]] = [[] for _ in range(n_ranks)]
    for leaf in zip(*grads, *errors):
        a, e = compressed_psum(leaf[:n_ranks], leaf[n_ranks:])
        for r in range(n_ranks):
            avgs[r].append(a[r])
            errs[r].append(e[r])
    return avgs, errs


__all__ = ["quantize_int8", "dequantize_int8", "topk_sparsify",
           "compressed_psum", "compress_tree_psum"]
