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

Over a mesh the parameters are a placed model (``models/parallel.py``),
which names every copy of every shard (``named_copies``) and the first
copy of each (``firsts``): the state holds moments one a copy, shaped as
the shard, and ``update`` visits the copies, the global norm summing each
distinct shard once.  The clipping scale, learning rate and bias
corrections are computed once, on the first leaf's device, and copied to
the others; a leaf's decay follows the reference's rank of its name.  The
learning rate stays a tensor there (``p - lr delta`` one ``addcmul``), so
that a mesh's step never waits on the card: a fused multiply-add on the
CPU, but on the card ``addcmul`` rounds lr delta before the add, an ulp
from the reference at some elements.  One device's update reads lr to
the host once a step, the exact multiplier of ``add(alpha=-lr)``.
"""

from __future__ import annotations

import contextlib
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


def _layout(params):
    """(name, tensor) of what the state covers, the indices of those the
    global norm sums, and whether the model is placed over a mesh: a
    model's leaves, or every copy of every shard of a placed model and
    each shard's first copy."""
    if hasattr(params, "named_copies"):
        return params.named_copies(), params.firsts(), True
    named = named_leaves(params)
    return named, range(len(named)), False


def init(cfg: AdamWConfig, params) -> dict:
    """Zero moments, one a leaf in leaf order (one a copy of each shard of
    a placed model), and step 0 (int32), on the first leaf's device."""
    dt = _DTYPES[cfg.moment_dtype]
    leaves = [leaf for _, leaf in _layout(params)[0]]
    device = leaves[0].device if leaves else None
    return {"m": [torch.zeros(p.shape, dtype=dt, device=p.device)
                  for p in leaves],
            "v": [torch.zeros(p.shape, dtype=dt, device=p.device)
                  for p in leaves],
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of the leaves' float32 sums of squares, in leaf
    order on the first leaf's device."""
    flat = [g for _, g in named_leaves(grads)]
    home = flat[0].device
    sums = [torch.sum(torch.square(g.float())).to(home) for g in flat]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """float32 sqrt, correctly rounded as the reference's is.  The card's
    float32 sqrt is; the CPU's vectorised one is not, so there the root
    goes through float64, whose sqrt of a float32 value rounds to float32
    exactly once.  Writes over `x` on the card."""
    if x.device.type == "cpu":
        return torch.sqrt(x.to(torch.float64)).to(torch.float32)
    return x.sqrt_()


def _update_chunk(cfg: AdamWConfig, p, g, m, v, scale, lr, c1, c2,
                  decay: bool) -> None:
    """One stretch of a leaf, written in place: the reference's formulas
    in the form its compiler runs them.  Each multiply-add is one
    ``torch.add(c, a, alpha=s)``, a fused multiply-add on the card and on
    the CPU (rounded once, as the reference's contractions are), and
    mhat / (sqrt(vhat) + eps) is m / (c1 (sqrt(v / c2) + eps)).  `lr` is
    a float, or a tensor on p's device (``addcmul``; module docstring)."""
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
    if isinstance(lr, torch.Tensor):
        p32.addcmul_(delta, lr, value=-1)
    else:
        p32.add_(delta, alpha=-lr)
    for dst, src in ((p, p32), (m, m32), (v, v32)):
        if dst is not src:
            dst.copy_(src)


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state: dict, params):
    """Returns (params, state, metrics {"grad_norm", "lr"}); `grads` is a
    list in leaf order or a tree shaped as `params` (over a mesh, a list
    one a copy, each copy holding its shard's whole gradient:
    ``ShardedLM.sum_copies``).  The parameters and the state's moments
    are written in place."""
    step = state["step"] + 1
    named, firsts, placed = _layout(params)
    flat_g = [g for _, g in named_leaves(grads)]
    if len(flat_g) != len(named):
        raise ValueError(f"{len(flat_g)} gradients for {len(named)} leaves")
    gnorm = global_norm([flat_g[i] for i in firsts])
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9),
                            1.0) if cfg.clip_norm > 0 else \
        torch.ones((), dtype=torch.float32, device=gnorm.device)
    lr = schedule(cfg, step)
    c1 = 1 - torch.pow(cfg.b1, step.to(torch.float32))
    c2 = 1 - torch.pow(cfg.b2, step.to(torch.float32))
    home = gnorm.device
    consts = {home: (scale, lr if placed else float(lr), c1, c2)}
    for i, ((name, p), g, m, v) in enumerate(zip(named, flat_g, state["m"],
                                                 state["v"])):
        if p.device not in consts:   # copied once a device
            consts[p.device] = tuple(t.to(p.device) if isinstance(
                t, torch.Tensor) else t for t in consts[home])
        decay = reference_ndim(name, p) >= 2  # decoupled, matrices only
        pf, gf, mf, vf = (t.view(-1) for t in (p, g, m, v))
        # a shard's update is the work of every rank that reads it (counted
        # so by the dry run's meter; nothing otherwise)
        with params.weighted(i) if placed else contextlib.nullcontext():
            for lo in range(0, pf.numel(), CHUNK):  # bounded temporaries
                sl = slice(lo, lo + CHUNK)
                _update_chunk(cfg, pf[sl], gf[sl], mf[sl], vf[sl],
                              *consts[p.device], decay)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}


__all__ = ["AdamWConfig", "init", "update", "schedule", "global_norm"]
