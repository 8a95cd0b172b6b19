"""Checkpoints: atomic step directories and a retaining, async manager.

Port of ``repro/checkpoint``; the on-disk layout is the reference's, so a
checkpoint of either package restores into the other by leaf name."""

from repro_torch.checkpoint import io
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["io", "CheckpointManager"]
