"""Checkpoint manager: retention, async save, resume policy.

Port of ``repro/checkpoint/manager.py``:
  * background saves (training never blocks on disk) with at-most-one
    in-flight save and completion draining; device tensors are copied to
    the host before the hand-off, so the loop may overwrite them;
  * retention (keep_last N + keep_every K "anchor" steps, so a bad-data
    incident can roll back far while bounding storage);
  * resume picks the newest complete step and GCs debris from interrupted
    saves (crash-consistent).
"""

from __future__ import annotations

import os
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Optional, Tuple

import torch

from repro_torch.checkpoint import io


def _to_host(tree):
    """The tree with every device tensor copied to the host, as the
    reference's ``jax.device_get``; host tensors are kept as they are."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.device.type != "cpu":
        return tree.detach().to("cpu")
    return tree


class CheckpointManager:
    def __init__(self, root: str, *, keep_last: int = 3,
                 keep_every: int = 0, async_save: bool = True):
        self.root = root
        self.keep_last = keep_last
        self.keep_every = keep_every
        self._pool = ThreadPoolExecutor(max_workers=1) if async_save else None
        self._inflight: Optional[Future] = None
        os.makedirs(root, exist_ok=True)
        io.gc_tmp(root)

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: Any, metadata: Optional[dict] = None,
             block: bool = False) -> None:
        """Save (async by default).  Device tensors are copied to the host
        *before* handing off, so the loop may overwrite them; host tensors
        are handed off as they are and must stay unchanged until the save
        is done (``wait``)."""
        host_tree = _to_host(tree)
        if self._pool is None or block:
            self.wait()
            io.save(self.root, step, host_tree, metadata=metadata)
            self._retain()
        else:
            self.wait()  # at most one in-flight save
            self._inflight = self._pool.submit(self._save_job, step,
                                               host_tree, metadata)

    def _save_job(self, step, host_tree, metadata):
        io.save(self.root, step, host_tree, metadata=metadata)
        self._retain()

    def wait(self) -> None:
        if self._inflight is not None:
            self._inflight.result()
            self._inflight = None

    # -- retention ----------------------------------------------------------

    def _retain(self) -> None:
        steps = io.available_steps(self.root)
        if len(steps) <= self.keep_last:
            return
        keep = set(steps[-self.keep_last:])
        if self.keep_every:
            keep |= {s for s in steps if s % self.keep_every == 0}
        for s in steps:
            if s not in keep:
                shutil.rmtree(os.path.join(self.root, f"step_{s:08d}"),
                              ignore_errors=True)

    # -- resume ---------------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        steps = io.available_steps(self.root)
        return steps[-1] if steps else None

    def restore_latest(self, like: Any, devices=None
                       ) -> Optional[Tuple[Any, dict, int]]:
        """Returns (tree, metadata, step) or None if no checkpoint exists;
        the leaves land on `devices` (one device for all), else the CPU."""
        step = self.latest_step()
        if step is None:
            return None
        path = os.path.join(self.root, f"step_{step:08d}")
        tree, meta = io.restore(path, like=like, device=devices)
        return tree, meta, step

    def close(self) -> None:
        self.wait()
        if self._pool is not None:
            self._pool.shutdown(wait=True)


__all__ = ["CheckpointManager"]
