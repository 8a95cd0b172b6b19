"""Step functions: train / prefill / decode, for every LM family.

Port of ``repro/models/steps.py``.  The serving steps (``make_prefill_step``,
``make_decode_step``) run under ``torch.no_grad()``; the training step runs
autograd (``torch.autograd.grad``) and the AdamW update of
``optim/adamw.py``, which writes the parameters and moments in place.

Memory discipline, as in the reference:
* loss is computed in sequence chunks (cfg.logits_chunk tokens), each
  recomputed in the backward pass, so the (B, S, V) logits tensor never
  materialises;
* gradient accumulation (cfg.grad_accum) runs micro-batches one after
  another, bounding activation memory at micro-batch scale;
* every layer is recomputed in the backward pass (cfg.remat, ``L.remat``).

Training attention takes the plain route on both devices (the flash
kernel has no backward; ``models/layers.self_attention``).  The serving
steps take the reference's sharding ``policy=`` and run over its mesh
(``models/parallel.py``); the training step takes none: training over a
model axis is the next slice (``runtime/train_loop.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.allpairs import resolve_device
from repro_torch.models import encdec, transformer
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.parallel import ShardedLM
from repro_torch.optim import adamw
from repro_torch.tree import leaves

Tensor = torch.Tensor


def as_batch(batch: dict, device) -> dict:
    """A batch's arrays (numpy or tensors) as tensors on `device`."""
    return {k: (torch.from_numpy(np.asarray(v, order="C"))
                if isinstance(v, np.ndarray) else v).to(device)
            for k, v in batch.items() if v is not None}


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def xent_sums(cfg: ModelConfig, params, hidden: Tensor,
              labels: Tensor):
    """(sum of the token losses, count of the non-pad tokens), float32, of
    next-token cross-entropy without materialising (B, S, V) logits.

    hidden: (B, S, D) post-final-norm.  labels: (B, S) (-1 = pad).  Chunks
    along S (cfg.logits_chunk; unchunked when it does not divide S); each
    chunk projects to logits, takes logsumexp and gathers the label logit,
    and is recomputed in the backward pass unless cfg.remat is "none".
    """
    b, s, d = hidden.shape
    head = (params.embed.T if cfg.tie_embeddings
            else params.lm_head).to(hidden.dtype)
    chunk = cfg.logits_chunk if cfg.logits_chunk > 0 else s
    chunk = min(chunk, s)
    if s % chunk:
        chunk = s  # fall back to unchunked for ragged seqs (tests)

    def body(hc, lc):
        logits = (hc @ head).to(torch.float32)            # (B, C, V)
        lse = torch.logsumexp(logits, dim=-1)
        lab = torch.gather(logits, -1,
                           torch.clamp_min(lc, 0).long()[..., None])[..., 0]
        valid = (lc >= 0).to(torch.float32)
        return torch.sum((lse - lab) * valid), torch.sum(valid)

    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s, chunk):
        t, c = L.remat(cfg, body, hidden[:, c0:c0 + chunk],
                       labels[:, c0:c0 + chunk])
        tot, cnt = tot + t, cnt + c
    return tot, cnt


def chunked_xent(cfg: ModelConfig, params, hidden: Tensor,
                 labels: Tensor) -> Tensor:
    """Mean next-token cross-entropy over the non-pad tokens
    (``xent_sums``)."""
    tot, cnt = xent_sums(cfg, params, hidden, labels)
    return tot / torch.clamp_min(cnt, 1.0)


def loss_fn(cfg: ModelConfig, params, batch: dict,
            count: Optional[float] = None) -> tuple:
    """Forward + loss for one (micro-)batch of tensors.  Returns (loss,
    metrics {"loss", "xent", "aux"}).  ``count`` divides the token losses'
    sum in place of this batch's own count: a data rank's share of a
    global token mean (``runtime/train_loop.py``)."""
    if cfg.enc_dec:
        hidden, aux, _ = encdec.forward(cfg, params, src=batch["src"],
                                        tokens=batch["tokens"])
    else:
        hidden, aux, _ = transformer.forward(
            cfg, params, tokens=batch.get("tokens"),
            embeds=batch.get("embeds"), positions=batch.get("positions"))
    aux = torch.as_tensor(aux, dtype=torch.float32, device=hidden.device)
    tot, cnt = xent_sums(cfg, params, hidden, batch["labels"])
    xent = tot / (torch.clamp_min(cnt, 1.0) if count is None else count)
    loss = xent + aux
    return loss, {"loss": loss, "xent": xent, "aux": aux}


def grads_of(cfg: ModelConfig, params, batch: dict,
             count: Optional[float] = None):
    """(metrics, gradients in leaf order) of ``loss_fn``; a leaf the loss
    does not reach gets zeros, as jax.grad gives it."""
    flat = leaves(params)
    loss, metrics = loss_fn(cfg, params, batch, count=count)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return {k: v.detach() for k, v in metrics.items()}, grads


def micro_batches(batch: dict, k: int) -> list:
    """The k micro-batches of a batch, rows split in order (the
    reference's reshape to (k, B / k, ...))."""
    n = next(iter(batch.values())).shape[0]
    if n % k:
        raise ValueError(f"batch {n} does not split into {k} micro-batches")
    return [{name: a[i * (n // k):(i + 1) * (n // k)]
             for name, a in batch.items()} for i in range(k)]


def accumulated_grads(cfg: ModelConfig, batch: dict, grads_fn):
    """(metrics, gradients) of a batch over cfg.grad_accum = k
    micro-batches, ``grads_fn(micro_batch) -> (metrics, gradients)``: with
    k > 1 the float32 gradients summed and divided by k, the metrics the
    last micro-batch's, as the reference's scan carries them."""
    k = cfg.grad_accum
    if k == 1:
        return grads_fn(batch)
    gsum = None
    for mb in micro_batches(batch, k):
        metrics, g = grads_fn(mb)
        g = [x.to(torch.float32) for x in g]
        gsum = g if gsum is None else [a + b for a, b in zip(gsum, g)]
    return metrics, [g / k for g in gsum]


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    device=None):
    """(params, opt_state, **batch) -> (params, opt_state, metrics).

    Runs on `device` (None means "cuda", which raises without a card):
    the batch's arrays move there, and the parameters (a trainable model,
    ``init_params(..., trainable=True)``) must lie there.  cfg.grad_accum
    micro-batches as ``accumulated_grads``.  The parameters and moments
    are updated in place and returned."""
    dev = resolve_device(device)

    def step(params, opt_state, **batch):
        if isinstance(params, ShardedLM):
            raise NotImplementedError(
                "training over a sharded placement is the training half of "
                "ROADMAP A part 5; serving executes it")
        first = next(params.parameters())
        if first.device.type != dev.type:
            raise ValueError(f"the parameters lie on {first.device}, the "
                             f"step runs on {dev}")
        metrics, grads = accumulated_grads(
            cfg, as_batch(batch, first.device),
            lambda mb: grads_of(cfg, params, mb))
        params, opt_state, om = adamw.update(opt_cfg, grads, opt_state,
                                             params)
        return params, opt_state, dict(metrics, **om)

    return step


def _placed(params, policy) -> None:
    """Raises ValueError unless `params` are placed by `policy` (a
    ``parallel.ShardedLM``) where a policy is given, and are one device's
    where none is."""
    if policy is None:
        if isinstance(params, ShardedLM):
            raise ValueError("placed parameters run in a step given the "
                             "policy= that placed them")
        return
    if not isinstance(params, ShardedLM):
        raise ValueError("a step with a sharding policy runs parameters "
                         "placed by it: build_model(cfg).init(mesh=) or "
                         "convert.lm_params_from_reference(mesh=)")
    if params.policy != policy:
        raise ValueError(f"the parameters are placed by {params.policy}, "
                         f"the step's policy is {policy}")


def make_prefill_step(cfg: ModelConfig,
                      cache_capacity: Optional[int] = None, policy=None):
    """(params, **inputs) -> (last_logits (B, 1, V), cache).  Inputs:
    ``src`` and ``tokens`` for an encoder-decoder; else ``tokens`` or
    ``embeds``, and ``positions``.  With the reference's ``policy=`` the
    step runs over its mesh (``models/parallel.py``) on parameters placed
    by it (a ``parallel.ShardedLM``), its batch split over the data axes
    where it divides; the logits land on the first rank's device and the
    cache is a ``parallel.ShardedCache``."""
    trunk = encdec if cfg.enc_dec else transformer

    @torch.no_grad()
    def step(params, **batch):
        _placed(params, policy)
        if cfg.enc_dec:
            ins = {"src": batch["src"], "tokens": batch["tokens"]}
        else:
            ins = {name: batch.get(name)
                   for name in ("tokens", "embeds", "positions")}
        if policy is None:
            hidden, _, cache = trunk.forward(
                cfg, params, cache_capacity=cache_capacity, **ins)
            return transformer.project_logits(
                cfg, params, hidden[:, -1:, :]), cache
        first = ins["tokens"] if ins["tokens"] is not None else ins["embeds"]
        split = params.px.batch_split(first.shape[0])
        hidden, _, cache = trunk.forward_tp(
            cfg, params, split, cache_capacity=cache_capacity, **ins)
        return transformer.project_logits_tp(
            cfg, params, [h[:, -1:, :] for h in hidden], split), cache

    return step


def make_decode_step(cfg: ModelConfig, policy=None):
    """(params, token, cache, cache_index) -> (logits, cache), the cache
    written in place; over the policy's mesh as ``make_prefill_step``."""
    trunk = encdec if cfg.enc_dec else transformer

    @torch.no_grad()
    def step(params, *, token, cache, cache_index, positions=None):
        _placed(params, policy)
        if policy is None:
            return trunk.decode(cfg, params, cache, token, cache_index,
                                positions=positions)
        return trunk.decode_tp(cfg, params,
                               params.px.batch_split(token.shape[0]), cache,
                               token, cache_index, positions=positions)

    return step


def init_cache(cfg: ModelConfig, batch: int, capacity: int, device=None):
    """Zeroed decode caches; an encoder-decoder's holds an encoder output
    of `capacity` positions, as the reference's does."""
    if cfg.enc_dec:
        return encdec.init_cache(cfg, batch, capacity, capacity,
                                 device=device)
    return transformer.init_cache(cfg, batch, capacity, device=device)


__all__ = ["xent_sums", "chunked_xent", "loss_fn", "grads_of",
           "micro_batches", "accumulated_grads", "make_train_step",
           "make_prefill_step", "make_decode_step", "init_cache",
           "as_batch"]
