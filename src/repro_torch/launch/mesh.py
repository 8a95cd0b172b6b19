"""Device meshes: the port's counterpart of ``jax.sharding.Mesh``.

Port of ``make_mesh`` and ``describe`` of ``repro/launch/mesh.py``.  One
process drives every device of a mesh, as the reference's single
controller drives its ``shard_map``: the executor (core/allpairs.py) gives
each rank a CUDA stream on its device and hands the sinks per-rank pieces
of every pass.  A :class:`Mesh` keeps the attributes the reference reads
from a jax mesh (``devices``, ``axis_names``, ``shape``), so the ported
code reads like it.

Ranks flatten row-major over the axes (``rank = rank * shape[ax] +
index``), as the reference's ``_mesh_launches`` numbers them.  A device
may repeat: a mesh of p logical ranks over one device (``devices=["cpu"] *
p`` on the CPU, ``["cuda:0"] * p`` on one card) stands where the
reference's tests force a host device count
(``--xla_force_host_platform_device_count``), and runs every path of a
mesh but the peer copies between cards.

``make_production_mesh`` lays out the reference's production mesh, one
pod of (16, 16) ``("data", "model")`` ranks or two of them (``("pod",
"data", "model")``), as logical ranks on the meta device: the dry run
(``launch/dryrun.py``) runs the steps over it, allocating nothing.
"""

from __future__ import annotations

import collections
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def mesh_device(d) -> torch.device:
    """A mesh entry as a ``torch.device`` with its index: ``"cuda"`` is
    the current card.  A CUDA device on a machine without a card raises
    RuntimeError, one past the visible cards ValueError: a mesh never
    falls back to the CPU.  ``"meta"`` ranks hold shapes only (the dry
    run's)."""
    dev = torch.device(d)
    if dev.type in ("cpu", "meta"):
        return torch.device(dev.type)
    if dev.type != "cuda":
        raise ValueError(f"unsupported mesh device {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"mesh device {dev}: no CUDA device is available; a mesh of "
            f"CPU ranks is asked for with devices=['cpu'] * p")
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if not 0 <= index < torch.cuda.device_count():
        raise ValueError(
            f"mesh device cuda:{index} cannot be reached: "
            f"{torch.cuda.device_count()} CUDA device(s) visible")
    return torch.device("cuda", index)


def visible_devices() -> list:
    """Every visible CUDA device, in index order; RuntimeError without a
    card (a mesh of CPU ranks is asked for explicitly)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: a mesh over the visible cards "
            "needs one; pass devices=['cpu'] * p for a mesh of CPU ranks")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class Mesh:
    """Devices laid out over named axes.

    ``devices`` is a numpy object array of ``torch.device`` with one
    dimension per axis; ``shape`` maps each axis name to its size, in
    order; ``ranks`` lists the devices of the flat ranks, row-major.
    """

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        names = tuple(axis_names)
        if arr.ndim != len(names):
            raise ValueError(f"a mesh of shape {arr.shape} needs "
                             f"{arr.ndim} axis names, got {names}")
        if arr.size == 0:
            raise ValueError("a mesh needs at least one device")
        if len(set(names)) != len(names):
            raise ValueError(f"axis names repeat: {names}")
        flat = np.empty(arr.size, dtype=object)
        flat[:] = [mesh_device(d) for d in arr.reshape(-1)]
        self.devices = flat.reshape(arr.shape)
        self.axis_names = names

    @property
    def shape(self) -> "collections.OrderedDict[str, int]":
        return collections.OrderedDict(zip(self.axis_names,
                                           self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def ranks(self) -> Tuple[torch.device, ...]:
        """The device of each flat rank, row-major over the axes."""
        return tuple(self.devices.reshape(-1))

    @property
    def distinct_devices(self) -> Tuple[torch.device, ...]:
        """Each device of the mesh once, in rank order."""
        return tuple(dict.fromkeys(self.ranks))

    def __repr__(self) -> str:
        return describe(self)


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of the given shape over explicit devices (names, indices or
    ``torch.device``s; they may repeat), or over every visible CUDA device
    when ``devices`` is None, which raises without a card."""
    shape = tuple(int(s) for s in shape)
    devs = list(visible_devices() if devices is None else devices)
    if len(devs) != int(np.prod(shape)):
        raise ValueError(f"a mesh of shape {shape} needs "
                         f"{int(np.prod(shape))} devices, got {len(devs)}")
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh as logical ranks on the meta device:
    one pod = (16, 16) ``("data", "model")`` = 256 ranks; two pods = (2,
    16, 16) ``("pod", "data", "model")`` = 512.  It runs no device: a
    step over it composes shapes and allocates nothing (the dry run)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices=["meta"] * int(np.prod(shape)))


def describe(mesh: Mesh) -> str:
    dims = " x ".join(f"{n}={s}" for n, s in mesh.shape.items())
    devs = ", ".join(str(d) for d in mesh.distinct_devices)
    return f"Mesh({dims}; {mesh.size} ranks on {devs})"


__all__ = ["Mesh", "describe", "make_mesh", "make_production_mesh",
           "mesh_device", "visible_devices"]
