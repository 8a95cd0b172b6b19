"""Parameter trees in the reference's leaf order.

The reference keeps a model's parameters as a pytree of nested dicts whose
layer leaves are stacked (L, ...) under ``blocks`` (and ``enc_blocks``), and
everything that walks it (the optimizer, the checkpoint files, the sharding
specs) visits the leaves in ``jax.tree`` order: dict keys sorted at every
level.  The port holds one ``nn.Parameter`` a layer (``blocks.3.attn.wq``).
This module names each of the port's leaves by the reference's path
(``blocks/attn/wq``, layer 3), orders them as the reference does (path,
then layer), and stacks them into, or scatters them out of, the
reference's tree.

A *tree* here is an ``nn.Module`` (its parameters), a dict (keys sorted, as
jax sorts them), a list or tuple (by index), or a leaf: a tensor, a numpy
array or a number.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

# the stacked subtrees of the reference's parameters
STACKS = ("blocks", "enc_blocks")


def reference_path(name: str) -> Tuple[str, Optional[int]]:
    """A port parameter name ("blocks.3.attn.wq") as the reference's leaf
    path and layer ("blocks/attn/wq", 3); (path, None) outside a stack."""
    parts = name.split(".")
    if parts[0] in STACKS:
        return "/".join([parts[0]] + parts[2:]), int(parts[1])
    return "/".join(parts), None


def is_stacked(name: str) -> bool:
    """Whether a leaf is one layer of a stacked reference leaf."""
    return name.split(".", 1)[0] in STACKS


def reference_ndim(name: str, leaf) -> int:
    """The rank of the reference's leaf: one more than the port's inside a
    stack (the leading layer axis)."""
    return leaf.ndim + int(is_stacked(name))


def _order_key(name: str):
    path, layer = reference_path(name)
    return tuple(path.split("/")), -1 if layer is None else layer


def named_leaves(tree) -> List[Tuple[str, Any]]:
    """(name, leaf) pairs in the reference's leaf order.  A module's
    parameters keep their own names ("blocks.3.attn.wq"), sorted by the
    reference's path and then by layer; a dict's leaves are named by their
    "/"-joined keys, a list's by index."""
    if isinstance(tree, nn.Module):
        items = list(tree.named_parameters())
        items.sort(key=lambda item: _order_key(item[0]))
        return items
    out: List[Tuple[str, Any]] = []

    def walk(node, path):
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key], path + (str(key),))
        elif isinstance(node, (list, tuple)):
            for i, sub in enumerate(node):
                walk(sub, path + (str(i),))
        elif node is not None:
            out.append(("/".join(path), node))
    walk(tree, ())
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in named_leaves(tree)]


def stacked_tree(names: Sequence[str], tensors: Sequence[torch.Tensor],
                 device="cpu") -> Dict[str, Any]:
    """The reference's nested dict of the leaves `tensors` named `names`
    (port names, as ``named_leaves`` of a model gives them): a layer
    stack's leaves stacked (L, ...) on `device`, the others copied there."""
    groups: Dict[str, list] = {}
    for name, t in zip(names, tensors):
        path, layer = reference_path(name)
        groups.setdefault(path, []).append((layer, t))
    tree: Dict[str, Any] = {}
    for path, members in groups.items():
        if members[0][0] is None:
            value = members[0][1].detach().to(device, copy=True)
        else:
            members.sort(key=lambda m: m[0])
            first = members[0][1]
            value = torch.empty((len(members),) + tuple(first.shape),
                                dtype=first.dtype, device=device)
            for i, (_, t) in enumerate(members):
                value[i].copy_(t.detach())
        node = tree
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def lookup(tree: Dict[str, Any], path: str):
    node = tree
    for part in path.split("/"):
        node = node[part]
    return node


def scatter_tree(names: Sequence[str], tensors: Sequence[torch.Tensor],
                 tree: Dict[str, Any]) -> None:
    """Copy the reference's tree `tree` (stacked leaves: tensors or numpy
    arrays) into the port's leaves `tensors` named `names`, in place.
    Raises ValueError when a leaf's shape or dtype differs."""
    with torch.no_grad():
        for name, t in zip(names, tensors):
            path, layer = reference_path(name)
            src = lookup(tree, path)
            if isinstance(src, np.ndarray):
                src = torch.from_numpy(np.asarray(src, order="C"))
            if layer is not None:
                src = src[layer]
            if tuple(src.shape) != tuple(t.shape) or src.dtype != t.dtype:
                raise ValueError(
                    f"{name}: the tree holds {src.dtype} "
                    f"{tuple(src.shape)}, the leaf is {t.dtype} "
                    f"{tuple(t.shape)}")
            t.copy_(src)


__all__ = ["STACKS", "reference_path", "is_stacked", "reference_ndim",
           "named_leaves", "leaves", "stacked_tree", "lookup",
           "scatter_tree"]
