"""Checkpoint IO: atomic, resumable, in the reference's on-disk layout.

Port of ``repro/checkpoint/io.py``.  Layout (one directory per step):

    <root>/step_00000123.tmp-<nonce>/   # written here first
        manifest.json                   # step, metadata, one record a leaf
        arr_00000.npy ...               # one file per leaf
    <root>/step_00000123/               # atomic os.replace on completion

Atomicity: a checkpoint is visible iff the final rename happened, so a
mid-write failure can never leave a half-readable step (the stale .tmp
directory is garbage-collected on the next save).  The manifest is written
last; its presence marks the leaf files complete.

Leaves are named as the reference names them ("/"-joined dict keys and
list indices, dict keys sorted: ``tree.named_leaves``) and written in that
order, so the reference's ``restore``, which reads the files in manifest
order into its own tree, takes the port's checkpoints, and the port's
``restore`` reads either package's by name.  A bfloat16 leaf is written
as numpy writes an ``ml_dtypes`` bfloat16 array (two-byte void records,
dtype "bfloat16" in the manifest) and read back through the manifest's
dtype as 16-bit integers viewed as ``torch.bfloat16``: no ``ml_dtypes``
is needed.
"""

from __future__ import annotations

import json
import os
import shutil
import uuid
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import named_leaves

# torch dtypes numpy has no type for: written as their bits in void
# records, as numpy writes the ml_dtypes types, and read back by name
_BITS = {"bfloat16": (torch.bfloat16, torch.int16, np.int16)}


def _host_array(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as the numpy array to write and its manifest dtype name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        name = str(t.dtype).removeprefix("torch.")
        if name in _BITS:
            bits = t.contiguous().view(_BITS[name][1]).numpy()
            return bits.view(np.dtype(f"V{bits.itemsize}")), name
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(root: str, step: int, tree: Any, *,
         metadata: Optional[dict] = None) -> str:
    """Write a checkpoint atomically; returns the final directory."""
    final = os.path.join(root, f"step_{step:08d}")
    tmp = f"{final}.tmp-{uuid.uuid4().hex[:8]}"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "metadata": metadata or {}, "leaves": []}
    for i, (name, leaf) in enumerate(named_leaves(tree)):
        arr, dtype = _host_array(leaf)
        fn = f"arr_{i:05d}.npy"
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"].append({"name": name, "file": fn,
                                   "shape": list(arr.shape),
                                   "dtype": dtype})
    # manifest last: its presence marks leaf files complete
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def _load(path: str, rec: dict) -> torch.Tensor:
    arr = np.load(os.path.join(path, rec["file"]))
    if rec["dtype"] in _BITS:
        dtype, _, bits = _BITS[rec["dtype"]]
        return torch.from_numpy(np.asarray(arr, order="C").view(bits)) \
            .view(dtype)
    return torch.from_numpy(np.asarray(arr, order="C"))


def restore(path: str, like: Any = None, device=None) -> Tuple[Any, dict]:
    """Read a checkpoint directory; returns (tree, metadata).

    Without `like`, the tree is the list of leaves in manifest order, as
    the reference returns it.  With `like` (a tree of dicts and lists), each
    of its leaves is filled by name from the record of that name; ValueError
    when a name is missing or a shape differs.  Leaves are CPU tensors, or
    land on `device`.
    """
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    records = manifest["leaves"]

    def place(t):
        return t if device is None else t.to(device)

    if like is None:
        return [place(_load(path, rec)) for rec in records], \
            manifest["metadata"]
    by_name = {rec["name"]: rec for rec in records}
    loaded = {}
    for name, leaf in named_leaves(like):
        if name not in by_name:
            raise ValueError(f"{path}: no leaf named {name!r}")
        t = _load(path, by_name[name])
        want = tuple(np.shape(leaf))
        if tuple(t.shape) != want:
            raise ValueError(f"{path}: {name!r} is {tuple(t.shape)}, "
                             f"expected {want}")
        loaded[name] = place(t)
    return _build(like, (), loaded), manifest["metadata"]


def _build(node, prefix: tuple, loaded: dict):
    """`node`'s structure with each leaf the loaded tensor of its path
    (module-level: a nested function calling itself is a reference
    cycle, which would hold every loaded leaf until a collection)."""
    if isinstance(node, dict):
        return {k: _build(v, prefix + (str(k),), loaded)
                for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_build(v, prefix + (str(i),), loaded)
                          for i, v in enumerate(node))
    if node is None:
        return None
    return loaded["/".join(prefix)]


def available_steps(root: str) -> list:
    """Complete (manifest-bearing) checkpoint steps, ascending."""
    if not os.path.isdir(root):
        return []
    steps = []
    for d in os.listdir(root):
        if d.startswith("step_") and ".tmp-" not in d:
            if os.path.exists(os.path.join(root, d, "manifest.json")):
                try:
                    steps.append(int(d.split("_")[1]))
                except ValueError:
                    continue
    return sorted(steps)


def gc_tmp(root: str) -> int:
    """Remove stale .tmp-* dirs from interrupted saves; returns count."""
    if not os.path.isdir(root):
        return 0
    n = 0
    for d in os.listdir(root):
        if ".tmp-" in d:
            shutil.rmtree(os.path.join(root, d), ignore_errors=True)
            n += 1
    return n


__all__ = ["save", "restore", "available_steps", "gc_tmp"]
