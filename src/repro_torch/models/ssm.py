"""Mamba-1 selective SSM block (falcon-mamba / hymba SSM heads).

Port of ``repro/models/ssm.py``.  The full-sequence scan keeps the
reference's structure: an outer loop over ``ssm_chunk``-long chunks carries
the (B, d_inner, state) boundary state, and each chunk runs a log-depth
scan that materialises (B, Q, d_inner, state) transiently.  torch has no
``associative_scan``, so the chunk's scan is a Hillis-Steele doubling scan
on (a, b) pairs with the reference's operator: log2(Q) rounds of
elementwise products, not a loop over tokens.  Under autograd each chunk
is recomputed in the backward pass unless cfg.remat is "none", as the
reference checkpoints its chunk body.  A ragged sequence (S not a
multiple of the chunk) runs as one chunk, as in the reference.

Decode is the O(1) recurrence h' = exp(dt*A) h + dt*B*x with a (d_conv-1)
ring of raw inputs for the causal depthwise conv.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _device, dense_init, remat
from repro_torch.models.parallel import Out, mm32

Tensor = torch.Tensor


def init_ssm(gen, cfg: ModelConfig, device=None) -> dict:
    d, di, n, r = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    dev = _device(gen, device)
    # S4D-real initialisation of A: A[d, j] = -(j + 1)
    a_init = torch.arange(1, n + 1, dtype=torch.float32,
                          device=dev)[None, :].repeat(di, 1)
    return {
        "in_proj": dense_init(gen, (d, 2 * di), dev),
        "conv_w": dense_init(gen, (cfg.ssm_conv, di), dev, scale=0.5),
        "conv_b": torch.zeros((di,), device=dev),
        "x_proj": dense_init(gen, (di, r + 2 * n), dev),
        "dt_proj": dense_init(gen, (r, di), dev, scale=r ** -0.5),
        "dt_bias": torch.log(torch.expm1(torch.full((di,), 0.01,
                                                    device=dev))),
        "A_log": torch.log(a_init),
        "D": torch.ones((di,), device=dev),
        "out_proj": dense_init(gen, (di, d), dev,
                               scale=0.02 / max(cfg.n_layers, 1) ** 0.5),
    }


def _causal_conv(x: Tensor, w: Tensor, b: Tensor,
                 prefix: Tensor = None) -> Tensor:
    """Depthwise causal conv.  x (B, S, di); w (K, di).  prefix: (B, K-1, di)
    carried inputs for decode continuity (None -> zero history)."""
    k = w.shape[0]
    if prefix is None:
        prefix = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                             device=x.device)
    xp = torch.cat([prefix, x], dim=1)
    s = x.shape[1]
    out = sum(xp[:, i:i + s, :] * w[i].to(x.dtype) for i in range(k))
    return out + b.to(x.dtype)


def _ssm_inputs(cfg: ModelConfig, p: Mapping[str, Tensor], xc: Tensor,
                proj: Tensor = None):
    """Common projections: xc (B, S, di) (post-conv, post-silu); `proj`,
    xc @ x_proj (B, S, r + 2n), when the caller has it (all-reduced over
    the model axis)."""
    n, r = cfg.ssm_state, cfg.dt_rank
    if proj is None:
        proj = xc @ p["x_proj"].to(xc.dtype)  # (B, S, r + 2n)
    dt_raw, b_mat, c_mat = torch.split(proj, [r, n, n], dim=-1)
    dt = F.softplus(dt_raw.float() @ p["dt_proj"].float()
                    + p["dt_bias"])                       # (B, S, di) f32
    a = -torch.exp(p["A_log"])                            # (di, n) f32
    return dt, a, b_mat.float(), c_mat.float()


def _ssm_front(p: Mapping[str, Tensor], x: Tensor, conv_prefix=None):
    """in_proj, split into x and z, then the causal conv and silu: (xi, z,
    xc), each (B, S, di).  On a rank, its di columns of x and of z."""
    xz = x @ p["in_proj"].to(x.dtype)
    xi, z = torch.chunk(xz, 2, dim=-1)
    xc = _causal_conv(xi, p["conv_w"], p["conv_b"], prefix=conv_prefix)
    return xi, z, F.silu(xc.float()).to(x.dtype)


def _doubling_scan(a: Tensor, b: Tensor) -> Tuple[Tensor, Tensor]:
    """Inclusive scan along axis 1 of the pairs (a, b) under the reference's
    operator (a1, b1) . (a2, b2) = (a2 a1, a2 b1 + b2), element 1 the
    earlier: Hillis-Steele, each round combining every element with the one
    `d` before it, d = 1, 2, 4, ..."""
    q = a.shape[1]
    d = 1
    while d < q:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return a, b


def ssm_apply(cfg: ModelConfig, p: Mapping[str, Tensor], x: Tensor,
              h0: Tensor = None) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
    """Full-sequence scan.  x (B, S, D) -> (y, (h_final, conv_tail)).
    conv_tail is the last (d_conv - 1) pre-conv inputs — the decode
    continuation state for the causal depthwise conv."""
    xi, z, xc = _ssm_front(p, x)
    y, state = _ssm_scan(cfg, p, x, xi, z, xc, None, h0)
    return y @ p["out_proj"].to(x.dtype), state


def _ssm_scan(cfg: ModelConfig, p: Mapping[str, Tensor], x: Tensor,
              xi: Tensor, z: Tensor, xc: Tensor, proj: Optional[Tensor],
              h0: Optional[Tensor]):
    """The selective scan over the front's outputs: (y (B, S, di) before
    out_proj, in x's dtype, (h_final, conv_tail))."""
    b, s, _ = x.shape
    n = cfg.ssm_state
    di = xc.shape[-1]
    dt, a, bm, cm = _ssm_inputs(cfg, p, xc, proj)

    q = min(cfg.ssm_chunk, s)
    if s % q:
        q = s  # ragged seq (tests): fall back to a single chunk
    xcf = xc.float()
    h = h0 if h0 is not None else torch.zeros((b, di, n), device=x.device)

    def chunk_body(h, xck, dtk, bmk, cmk):  # (B, Q, di) / (B, Q, n)
        da = torch.exp(dtk[..., None] * a)               # (B, Q, di, n)
        db = dtk[..., None] * bmk[:, :, None, :] * xck[..., None]
        a_cum, b_cum = _doubling_scan(da, db)
        hk = a_cum * h[:, None] + b_cum                  # (B, Q, di, n)
        return hk[:, -1], torch.einsum("bqdn,bqn->bqd", hk, cmk)

    ys = []
    for c0 in range(0, s, q):
        h, yk = remat(cfg, chunk_body, h, xcf[:, c0:c0 + q],
                      dt[:, c0:c0 + q], bm[:, c0:c0 + q], cm[:, c0:c0 + q])
        ys.append(yk)
    y = torch.cat(ys, dim=1)
    y = y + xcf * p["D"]
    y = (y * F.silu(z.float())).to(x.dtype)
    conv_tail = xi[:, -(cfg.ssm_conv - 1):, :]
    return y, (h, conv_tail)


def ssm_decode(cfg: ModelConfig, p: Mapping[str, Tensor], x: Tensor,
               h: Tensor, conv_cache: Tensor
               ) -> Tuple[Tensor, Tensor, Tensor]:
    """Single-token step.  x (B, 1, D); h (B, di, n); conv_cache
    (B, K-1, di) raw pre-conv inputs.  Returns (y, h', conv_cache')."""
    xi, z, xc = _ssm_front(p, x, conv_cache)     # (B, 1, di)
    y, h, conv_cache = _ssm_step(cfg, p, xi, z, xc, None, h, conv_cache)
    return y @ p["out_proj"].to(x.dtype), h, conv_cache


def _ssm_step(cfg: ModelConfig, p: Mapping[str, Tensor], xi: Tensor,
              z: Tensor, xc: Tensor, proj: Optional[Tensor], h: Tensor,
              conv_cache: Tensor):
    """The recurrence's step over the front's outputs: (y (B, 1, di)
    before out_proj, h', conv_cache')."""
    conv_cache = torch.cat([conv_cache[:, 1:], xi.to(conv_cache.dtype)],
                           dim=1)
    dt, a, bm, cm = _ssm_inputs(cfg, p, xc, proj)
    da = torch.exp(dt[:, 0, :, None] * a)                    # (B, di, n)
    db = dt[:, 0, :, None] * bm[:, 0, None, :] * xc[:, 0, :, None].float()
    h = da * h + db
    y = torch.einsum("bdn,bn->bd", h, cm[:, 0])[:, None, :]  # (B, 1, di)
    y = y + xc.float() * p["D"]
    return (y * F.silu(z.float())).to(xi.dtype), h, conv_cache


# ---------------------------------------------------------------------------
# Tensor-parallel forms (models/parallel.py): one list entry a rank
# ---------------------------------------------------------------------------


def _split_di(px, prefix: str) -> bool:
    """Whether the specs split d_inner over the model axis (out_proj's
    rows); in_proj then holds each rank's x and z columns."""
    return px.tp_dim(f"{prefix}/out_proj") == 0


def ssm_apply_tp(cfg: ModelConfig, px, ps, xs, prefix: str = "blocks/ssm"):
    """``ssm_apply`` over the model axis, d_inner split where the specs
    split it: each rank's in_proj columns, conv, scan and out_proj rows on
    its di, x_proj row-parallel with its (B, S, r + 2n) output all-reduced
    before the split into dt, B and C.  Returns (Out, each rank's (h_final
    (B, di, n), conv_tail (B, K-1, di)) of its di)."""
    if not _split_di(px, prefix):
        res = [ssm_apply(cfg, p, x) for p, x in zip(ps, xs)]
        return Out([y for y, _ in res], False), [st for _, st in res]
    fronts = [_ssm_front(p, x) for p, x in zip(ps, xs)]
    proj = px.all_reduce([mm32(xc, p["x_proj"])
                          for p, (_, _, xc) in zip(ps, fronts)], xs[0].dtype)
    ys, states = [], []
    for r, (p, x, (xi, z, xc)) in enumerate(zip(ps, xs, fronts)):
        y, st = _ssm_scan(cfg, p, x, xi, z, xc, proj[r], None)
        ys.append(mm32(y, p["out_proj"]))
        states.append(st)
    return Out(ys, True), states


def ssm_decode_tp(cfg: ModelConfig, px, ps, xs, hs, conv_caches,
                  prefix: str = "blocks/ssm"):
    """``ssm_decode`` over the model axis: each rank's state (B, di, n) and
    conv cache (B, K-1, di) hold its di.  Returns (Out, h's, caches)."""
    if not _split_di(px, prefix):
        res = [ssm_decode(cfg, p, x, h, c)
               for p, x, h, c in zip(ps, xs, hs, conv_caches)]
        return Out([r[0] for r in res], False), [r[1] for r in res], \
            [r[2] for r in res]
    fronts = [_ssm_front(p, x, c) for p, x, c in zip(ps, xs, conv_caches)]
    proj = px.all_reduce([mm32(xc, p["x_proj"])
                          for p, (_, _, xc) in zip(ps, fronts)], xs[0].dtype)
    ys, h_out, c_out = [], [], []
    for r, (p, (xi, z, xc)) in enumerate(zip(ps, fronts)):
        y, h, c = _ssm_step(cfg, p, xi, z, xc, proj[r], hs[r],
                            conv_caches[r])
        ys.append(mm32(y, p["out_proj"]))
        h_out.append(h)
        c_out.append(c)
    return Out(ys, True), h_out, c_out


__all__ = ["init_ssm", "ssm_apply", "ssm_decode", "ssm_apply_tp",
           "ssm_decode_tp"]
