"""Step functions: prefill and decode, for the decoder-only families.

Port of the serving half of ``repro/models/steps.py``
(``make_prefill_step``, ``make_decode_step``, ``init_cache``).  The training
half (``chunked_xent``, ``loss_fn``, ``make_train_step``), the
encoder-decoder branches and the sharding ``policy=`` wait for later slices
(ROADMAP A).  The steps run without autograd.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig,
                      cache_capacity: Optional[int] = None):
    """(params, **inputs) -> (last_logits (B, 1, V), cache)."""

    @torch.no_grad()
    def step(params, **batch):
        hidden, _, cache = transformer.forward(
            cfg, params, tokens=batch["tokens"],
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
        return transformer.decode(cfg, params, cache, token, cache_index,
                                  positions=positions)

    return step


def init_cache(cfg: ModelConfig, batch: int, capacity: int, device=None):
    return transformer.init_cache(cfg, batch, capacity, device=device)


__all__ = ["make_prefill_step", "make_decode_step", "init_cache"]
