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
kernel has no backward; ``models/layers.self_attention``).  Every step
takes the reference's sharding ``policy=``, and given one runs over its
mesh (``models/parallel.py``) on parameters placed by it, as the
reference's jitted steps run over the policy's shardings: the batch split over data
where it divides, the layers' tensor-parallel forms, the loss from each
data group's logits (``transformer.logits_tp``), autograd through the
collectives' copies and adds, each shard's copies' gradients summed
(``ShardedLM.sum_copies``) and AdamW on the distinct shards.  The mesh's
loss, gradients and update are the one-device step's up to the order of
float32 sums, an order that is the same in every run (``grads_of``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.allpairs import resolve_device
from repro_torch.models import encdec, transformer
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.parallel import ShardedLM, remat
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


def _chunk(cfg: ModelConfig, s: int) -> int:
    """Tokens a loss chunk: cfg.logits_chunk, unchunked when it is 0 or
    does not divide S (ragged sequences in tests)."""
    chunk = min(cfg.logits_chunk if cfg.logits_chunk > 0 else s, s)
    return s if s % chunk else chunk


def _token_sums(logits: Tensor, lc: Tensor):
    """(sum of the token losses, count of the non-pad tokens) of float32
    logits (B, C, V) against labels lc (B, C)."""
    lse = torch.logsumexp(logits, dim=-1)
    lab = torch.gather(logits, -1,
                       torch.clamp_min(lc, 0).long()[..., None])[..., 0]
    valid = (lc >= 0).to(torch.float32)
    return torch.sum((lse - lab) * valid), torch.sum(valid)


def xent_sums(cfg: ModelConfig, params, hidden: Tensor,
              labels: Tensor):
    """(sum of the token losses, count of the non-pad tokens), float32, of
    next-token cross-entropy without materialising (B, S, V) logits.

    hidden: (B, S, D) post-final-norm.  labels: (B, S) (-1 = pad).  Chunks
    along S (``_chunk``); each chunk projects to logits, takes logsumexp
    and gathers the label logit, and is recomputed in the backward pass
    unless cfg.remat is "none".
    """
    s = hidden.shape[1]
    head = (params.embed.T if cfg.tie_embeddings
            else params.lm_head).to(hidden.dtype)
    chunk = _chunk(cfg, s)

    def body(hc, lc):
        return _token_sums((hc @ head).to(torch.float32), lc)

    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s, chunk):
        t, c = L.remat(cfg, body, hidden[:, c0:c0 + chunk],
                       labels[:, c0:c0 + chunk])
        tot, cnt = tot + t, cnt + c
    return tot, cnt


def xent_sums_tp(cfg: ModelConfig, sm: ShardedLM, hidden: list,
                 labels: list, split: bool):
    """``xent_sums`` over the mesh of ``sm``: each data group's chunks
    projected to logits on its first rank's device
    (``transformer.logits_tp``), every chunk recomputed in the backward
    pass as on one device, so no (B, S, V) tensor is ever whole; the
    groups' sums added in group order on the first rank's device.
    hidden and labels: one a rank."""
    px = sm.px
    home = px.devices[0]
    s = labels[0].shape[1]
    chunk = _chunk(cfg, s)

    def body(d, hcs, lc):
        return _token_sums(transformer.logits_tp(cfg, sm, hcs, d)
                           .to(torch.float32), lc)

    tot = torch.zeros((), dtype=torch.float32, device=home)
    cnt = torch.zeros((), dtype=torch.float32, device=home)
    for d in range(px.dp if split else 1):
        g = px.group(d)
        for c0 in range(0, s, chunk):
            t, c = remat(cfg, body, d,
                         [hidden[r][:, c0:c0 + chunk] for r in g],
                         labels[g[0]][:, c0:c0 + chunk])
            tot, cnt = tot + t.to(home), cnt + c.to(home)
    return tot, cnt


def chunked_xent(cfg: ModelConfig, params, hidden: Tensor,
                 labels: Tensor) -> Tensor:
    """Mean next-token cross-entropy over the non-pad tokens
    (``xent_sums``)."""
    tot, cnt = xent_sums(cfg, params, hidden, labels)
    return tot / torch.clamp_min(cnt, 1.0)


def loss_fn(cfg: ModelConfig, params, batch: dict) -> tuple:
    """Forward + loss for one (micro-)batch of tensors.  Returns (loss,
    metrics {"loss", "xent", "aux"}).  Over a mesh (`params` a
    ``parallel.ShardedLM``) the batch is split over data where it divides
    (it must, over more than one data group), the token losses of every
    group summed over the batch's count, and the MoE aux loss counted
    once: the metrics land on the first rank's device."""
    trunk = encdec if cfg.enc_dec else transformer
    if cfg.enc_dec:
        ins = {"src": batch["src"], "tokens": batch["tokens"]}
    else:
        ins = {name: batch.get(name)
               for name in ("tokens", "embeds", "positions")}
    labels = batch["labels"]
    if isinstance(params, ShardedLM):
        px = params.px
        split = px.batch_split(labels.shape[0])
        if px.dp > 1 and not split:
            raise ValueError(f"a batch of {labels.shape[0]} rows does not "
                             f"split over {px.dp} data groups")
        hidden, aux, _ = trunk.forward_tp(cfg, params, split, **ins)
        tot, cnt = xent_sums_tp(cfg, params, hidden,
                                px.scatter(labels, split), split)
    else:
        hidden, aux, _ = trunk.forward(cfg, params, **ins)
        tot, cnt = xent_sums(cfg, params, hidden, labels)
    # a zero from a fill, not a copy of the host's 0.0 (a sync on a card)
    aux = torch.zeros((), dtype=torch.float32, device=tot.device) + aux
    xent = tot / torch.clamp_min(cnt, 1.0)
    loss = xent + aux
    return loss, {"loss": loss, "xent": xent, "aux": aux}


def grads_of(cfg: ModelConfig, params, batch: dict):
    """(metrics, gradients in leaf order) of ``loss_fn``; a leaf the loss
    does not reach gets zeros, as jax.grad gives it.  Over a mesh, one
    gradient a copy of each shard (``ShardedLM.copies``), each the part
    of its shard's gradient that the ranks reading that copy give.

    A mesh's backward runs on this thread alone.  Autograd otherwise
    runs a card's nodes on a thread of that card and adds the gradients
    a tensor receives in the order they arrive, which over several cards
    changes from one run to the next wherever three or more meet (a
    replicated activation's copies, a leaf's uses in the loss chunks);
    on one thread the nodes run in an order fixed by the graph, so every
    sum does too."""
    mesh = isinstance(params, ShardedLM)
    flat = params.copies if mesh else leaves(params)
    loss, metrics = loss_fn(cfg, params, batch)
    with torch.autograd.set_multithreading_enabled(not mesh):
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
                    device=None, policy=None):
    """(params, opt_state, **batch) -> (params, opt_state, metrics).

    Runs on `device` (None means "cuda", which raises without a card):
    the batch's arrays move there, and the parameters (a trainable model,
    ``init_params(..., trainable=True)``) must lie there.  With the
    reference's ``policy=`` it runs over the policy's mesh instead, on
    parameters placed by it (``build_model(cfg).init(mesh=,
    trainable=True)``, ``convert.lm_params_from_reference(mesh=,
    trainable=True)``) and their ``adamw.init`` state, the batch first on
    the first rank's device.  cfg.grad_accum micro-batches as
    ``accumulated_grads``.  The parameters and moments are updated in
    place and returned."""
    dev = resolve_device(device) if policy is None else None

    def step(params, opt_state, **batch):
        _placed(params, policy)
        if policy is None:
            home = next(params.parameters()).device
            if home.type != dev.type:
                raise ValueError(f"the parameters lie on {home}, the "
                                 f"step runs on {dev}")
        else:
            home = params.px.devices[0]
        metrics, grads = accumulated_grads(
            cfg, as_batch(batch, home),
            lambda mb: grads_of(cfg, params, mb))
        if policy is not None:
            grads = params.sum_copies(grads)
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


__all__ = ["xent_sums", "xent_sums_tp", "chunked_xent", "loss_fn",
           "grads_of",
           "micro_batches", "accumulated_grads", "make_train_step",
           "make_prefill_step", "make_decode_step", "init_cache",
           "as_batch"]
