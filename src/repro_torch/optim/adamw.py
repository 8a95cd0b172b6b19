"""Functional AdamW with global-norm clipping and configurable moment dtype.

Port of ``repro/optim/adamw.py``, formula for formula: clipping by the
global norm (floor 1e-9), bias corrections c1 / c2 in float32, decoupled
weight decay on leaves of rank >= 2 only, moments in ``moment_dtype``
(bf16 moments save 4 bytes a parameter), an int32 ``step``.  A library
optimizer (foreach or fused AdamW) is not this: its arithmetic differs.

The leaves are visited in the reference's leaf order (``tree.named_leaves``:
a model's parameters sorted by the reference's path, then layer), and the
rank that gates the decay is the reference's: a layer's leaf inside a
stack counts the stacked layer axis, so a block's norm weight (D,) decays
as the reference's (L, D) does.  ``update`` writes the parameters and the
moments in place under ``torch.no_grad()`` and returns them, in float32
elementwise passes whose multiply-adds are fused as the reference's
compiled update fuses them (``_update_chunk``): given the reference's
gradients its bits are the reference's.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.tree import named_leaves, reference_ndim

# elements of a leaf updated at once: bounds the float32 temporaries of
# the largest leaves (a 128K-vocabulary embedding)
CHUNK = 1 << 26
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio (float32)."""
    device = step.device if isinstance(step, torch.Tensor) else None
    step = torch.as_tensor(step, device=device).to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * frac))
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def init(cfg: AdamWConfig, params) -> dict:
    """Zero moments, one a leaf in leaf order, and step 0 (int32), on the
    leaves' device."""
    dt = _DTYPES[cfg.moment_dtype]
    leaves = [leaf for _, leaf in named_leaves(params)]
    device = leaves[0].device if leaves else None
    return {"m": [torch.zeros(p.shape, dtype=dt, device=p.device)
                  for p in leaves],
            "v": [torch.zeros(p.shape, dtype=dt, device=p.device)
                  for p in leaves],
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of the leaves' float32 sums of squares."""
    sums = [torch.sum(torch.square(g.float())) for _, g in named_leaves(grads)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """float32 sqrt, correctly rounded as the reference's is.  The card's
    float32 sqrt is; the CPU's vectorised one is not, so there the root
    goes through float64, whose sqrt of a float32 value rounds to float32
    exactly once.  Writes over `x` on the card."""
    if x.device.type == "cpu":
        return torch.sqrt(x.to(torch.float64)).to(torch.float32)
    return x.sqrt_()


def _update_chunk(cfg: AdamWConfig, p, g, m, v, scale, lr: float, c1, c2,
                  decay: bool) -> None:
    """One stretch of a leaf, written in place: the reference's formulas
    in the form its compiler runs them.  Each multiply-add is one
    ``torch.add(c, a, alpha=s)``, a fused multiply-add on the card and on
    the CPU (rounded once, as the reference's contractions are), and
    mhat / (sqrt(vhat) + eps) is m / (c1 (sqrt(v / c2) + eps))."""
    f32 = torch.float32
    g = g.to(f32) * scale
    # b1 m + (1 - b1) g: the moment's product is rounded into the sum for
    # float32 moments, the gradient's for narrower ones
    if m.dtype == f32:
        m32 = torch.add(g * (1 - cfg.b1), m, alpha=cfg.b1, out=m)
    else:
        m32 = torch.add(m.to(f32).mul_(cfg.b1), g, alpha=1 - cfg.b1)
    v32 = v if v.dtype == f32 else v.to(f32)
    torch.add(torch.mul(g, 1 - cfg.b2).mul_(g), v32, alpha=cfg.b2, out=v32)
    delta = _sqrt_rn(torch.div(v32, c2)).add_(cfg.eps).mul_(c1)
    torch.div(m32, delta, out=delta)
    p32 = p if p.dtype == f32 else p.to(f32)
    if decay:
        delta.add_(p32, alpha=cfg.weight_decay)
    p32.add_(delta, alpha=-lr)
    for dst, src in ((p, p32), (m, m32), (v, v32)):
        if dst is not src:
            dst.copy_(src)


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state: dict, params):
    """Returns (params, state, metrics {"grad_norm", "lr"}); `grads` is a
    list in leaf order or a tree shaped as `params`.  The parameters and
    the state's moments are written in place."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9),
                            1.0) if cfg.clip_norm > 0 else \
        torch.ones((), dtype=torch.float32, device=gnorm.device)
    lr = schedule(cfg, step)
    lr_f = float(lr)   # exact: the multiplier of the step's multiply-add
    c1 = 1 - torch.pow(cfg.b1, step.to(torch.float32))
    c2 = 1 - torch.pow(cfg.b2, step.to(torch.float32))

    named = named_leaves(params)
    flat_g = [g for _, g in named_leaves(grads)]
    if len(flat_g) != len(named):
        raise ValueError(f"{len(flat_g)} gradients for {len(named)} leaves")
    for (name, p), g, m, v in zip(named, flat_g, state["m"], state["v"]):
        decay = reference_ndim(name, p) >= 2  # decoupled, matrices only
        pf, gf, mf, vf = (t.view(-1) for t in (p, g, m, v))
        for lo in range(0, pf.numel(), CHUNK):  # elementwise: bounded temps
            sl = slice(lo, lo + CHUNK)
            _update_chunk(cfg, pf[sl], gf[sl], mf[sl], vf[sl], scale, lr_f,
                          c1, c2, decay)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}


__all__ = ["AdamWConfig", "init", "update", "schedule", "global_norm"]
