"""Step functions: prefill and decode, for every LM family.

Port of the serving half of ``repro/models/steps.py``
(``make_prefill_step``, ``make_decode_step``, ``init_cache``), with the
encoder-decoder branches.  The training half (``chunked_xent``,
``loss_fn``, ``make_train_step``) and the sharding ``policy=`` wait for
later slices (ROADMAP A).  The steps run without autograd.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import encdec, transformer
from repro_torch.models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig,
                      cache_capacity: Optional[int] = None):
    """(params, **inputs) -> (last_logits (B, 1, V), cache).  Inputs:
    ``src`` and ``tokens`` for an encoder-decoder; else ``tokens`` or
    ``embeds``, and ``positions``."""

    @torch.no_grad()
    def step(params, **batch):
        if cfg.enc_dec:
            hidden, _, cache = encdec.forward(
                cfg, params, src=batch["src"], tokens=batch["tokens"],
                cache_capacity=cache_capacity)
        else:
            hidden, _, cache = transformer.forward(
                cfg, params, tokens=batch.get("tokens"),
                embeds=batch.get("embeds"),
                positions=batch.get("positions"),
                cache_capacity=cache_capacity)
        last = hidden[:, -1:, :]
        return transformer.project_logits(cfg, params, last), cache

    return step


def make_decode_step(cfg: ModelConfig):
    """(params, token, cache, cache_index) -> (logits, cache), the cache
    written in place."""

    @torch.no_grad()
    def step(params, *, token, cache, cache_index, positions=None):
        trunk = encdec if cfg.enc_dec else transformer
        return trunk.decode(cfg, params, cache, token, cache_index,
                            positions=positions)

    return step


def init_cache(cfg: ModelConfig, batch: int, capacity: int, device=None):
    """Zeroed decode caches; an encoder-decoder's holds an encoder output
    of `capacity` positions, as the reference's does."""
    if cfg.enc_dec:
        return encdec.init_cache(cfg, batch, capacity, capacity,
                                 device=device)
    return transformer.init_cache(cfg, batch, capacity, device=device)


__all__ = ["make_prefill_step", "make_decode_step", "init_cache"]
