"""Optimizer substrate: AdamW with schedule and clipping, and int8
gradient compression for the data-parallel all-reduce.

Port of ``repro/optim``."""

from repro_torch.optim import adamw, compression
from repro_torch.optim.adamw import AdamWConfig

__all__ = ["adamw", "compression", "AdamWConfig"]
