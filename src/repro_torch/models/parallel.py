"""Executing a sharding policy's placement in one process.

The reference serves a sharded model by placing every parameter as
``policy.params_shardings`` says (``repro/models/sharding.py``) and
jitting its steps: GSPMD then splits each matmul over the mesh and inserts
the collectives.  The reference has no module that does this by hand, so
this module has no counterpart there.

One process drives every rank of a (data, model) mesh (``launch/mesh.py``:
explicit devices, which may repeat; ``["cpu"] * p`` on the CPU).
:class:`Placement` holds

* the ranks as a (data, model) grid, in the mesh's rank order;
* each parameter's shard on each rank's device, cut as its spec says
  (``ShardingPolicy.params_specs``): a dimension named by an axis is split
  contiguously over that axis, in rank order, and None keeps it whole.  A
  leaf that the spec keeps whole is one tensor for the ranks of one
  card.  One leaf departs from the spec's contiguous cut: an SSM's
  ``in_proj`` (D, 2 di) holds ``[x | z]``, and each rank keeps its x
  columns and its z columns together (as many bytes a rank as the spec);
* the collectives GSPMD would insert over the model axis of each data
  group, written as copies and adds.  ``all_reduce`` sums float32
  partials on the group's first device in rank order and rounds once to
  the activations' dtype, so a tensor-parallel layer differs from the
  one-device layer only by the order of a float32 sum; ``all_gather``
  concatenates the pieces.  Leaves that FSDP (``param_sharding="fsdp_tp"``)
  splits over the data axes are gathered there at their use and dropped
  after it (:class:`ShardedLM.parts`), and ``gather_data`` concatenates
  the data ranks' rows (the MoE layer's global routing).

Each collective can be recorded: with ``Placement.recorder`` a list, every
call appends one record (kind, dtype, one rank's operand dims, group) in
the reference's HLO names, before the copies are deduplicated by device,
and under autograd a hook on its output appends the backward's dual when
the gradient passes (an all-gather's reduce-scatter, an all-reduce's
all-reduce); ``runtime/hlo.collective_stats`` sums them.  With
``Placement.meter`` set (the dry run's op counter, ``launch/dryrun.py``)
:meth:`Placement.map` computes for every rank, as distinct cards would,
the collectives' own copies and adds are not counted, and
:meth:`Placement.weighted` counts a region as the work of the ranks
whose result it is.

A copy to another card is ``Tensor.to``: PyTorch queues it on the source
card's stream behind an event of the destination's stream, and makes the
destination's stream wait on an event after it, so the host never waits.
Between ranks of one device a copy is the tensor itself.

Training runs autograd through these copies, adds and concatenations:
an all-reduce's backward hands every partial the summed gradient of the
ranks' copies, an all-gather's a slice, and FSDP's gather at use gives
each data rank's shard the sum of every data rank's use (a
reduce-scatter).  A trainable placement holds one ``nn.Parameter`` a
distinct shard on a card (``Placement.build``), shared by the ranks of
that card that read it, so autograd sums their uses; the copies of a
shard on other devices (a replicated leaf's on each card) each get their
ranks' partial, which ``ShardedLM.sum_copies`` adds in copy order and
hands back to every copy.  ``ShardedLM.shards`` lists each distinct shard
once, for AdamW, the global norm and the checkpoint.  The backward runs
on one thread (``steps.grads_of``), so that every gradient sum it forms
runs in the same order in every run.

Ranks on one card share a shard they read alike; ranks on the CPU each
hold their own copy, standing in for ranks on distinct cards, so that
the CPU runs the copies' path the cards run.

Activations are lists with one tensor a rank; ranks of one device share a
replicated activation, and :meth:`Placement.map` computes a rank-wise
function once for them.  The layers' tensor-parallel forms live beside
their one-device forms (``layers.py``, ``ssm.py``, ``transformer.py``,
``encdec.py``); :class:`ShardedLM` holds the parameters they run on,
:class:`ShardedCache` the decode caches.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from functools import reduce
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.tree import named_leaves, order_key, reference_path

Tensor = torch.Tensor

# the float32-output GEMMs of bf16 / fp16 operands (torch.mm(out_dtype=)),
# on the card where the installed torch has them
_MM_DTYPE = "dtype" in torch.ops.aten.mm.overloads()
_BMM_DTYPE = "dtype" in torch.ops.aten.bmm.overloads()


class _MM32(torch.autograd.Function):
    """a @ b by the card's float32-output GEMM, differentiated as the
    one-device layer's product: the backward narrows the float32 gradient
    to the operands' dtype and runs the one-device products on it.  Where
    the partial's float32 sum is rounded once to that dtype
    (``Placement.all_reduce``, ``logits_tp``) the gradient reaching it is
    such a value widened, and narrows exactly; where a float32 factor
    scales the partial first (the MoE combine's router weights) it is
    rounded, as the one-device product's gradient is."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if b.ndim == 3:
            return torch.bmm(a, b, out_dtype=torch.float32)
        out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], b.shape[-1])

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        if b.ndim == 3:
            return torch.bmm(g, b.transpose(1, 2)), \
                torch.bmm(a.transpose(1, 2), g)
        g2 = g.reshape(-1, g.shape[-1])
        return (g2 @ b.T).reshape(a.shape), \
            a.reshape(-1, a.shape[-1]).T @ g2


def mm32(a: Tensor, b: Tensor) -> Tensor:
    """a @ b with a float32 result: a row-parallel partial.  b is cast to
    a's dtype first, as the one-device layer casts it, so both multiply
    the same operands; bf16 / fp16 products sum in float32 and are not
    rounded to the operands' dtype (``torch.mm(out_dtype=torch.float32)``
    on the card where torch offers it, through :class:`_MM32` under
    autograd too, else the operands widened to float32).  a (..., K), b
    (K, N), or batched a (E, M, K), b (E, K, N)."""
    b = b.to(a.dtype)
    if a.dtype == torch.float32:
        return torch.bmm(a, b) if b.ndim == 3 else a @ b
    if a.is_cuda and (_BMM_DTYPE if b.ndim == 3 else _MM_DTYPE):
        return _MM32.apply(a, b)
    if b.ndim == 3:
        return torch.bmm(a.float(), b.float())
    return a.float() @ b.float()


class _Recompute:
    """A region of a mesh's forward whose saved tensors are dropped and made
    again when the backward pass first asks for one (``remat``).  Its
    saved tensors lie on several cards: the first unpack recomputes the
    region for all, under a lock should autograd run the cards' nodes on
    threads of their own (``torch.utils.checkpoint`` recomputes unlocked,
    and two cards' threads asking at once break it; ``steps.grads_of``
    runs a mesh's backward on one thread).  Each recomputed tensor is
    handed out once; a later backward pass recomputes again."""

    def __init__(self, fn, args):
        self.fn, self.args = fn, args
        self.meta: list = []          # (shape, dtype, device) a saved tensor
        self.saved: Optional[list] = None
        self.lock = threading.Lock()

    def pack(self, t: Tensor) -> int:
        self.meta.append((t.shape, t.dtype, t.device))
        return len(self.meta) - 1

    def unpack(self, i: int) -> Tensor:
        with self.lock:
            if self.saved is None or self.saved[i] is None:
                saved: list = []
                memo: dict = {}
                with torch.enable_grad(), \
                        torch.autograd.graph.saved_tensors_hooks(
                            lambda t: saved.append(
                                t.detach() if t.requires_grad else t),
                            lambda _: None):
                    self.fn(*_detached(self.args, memo))
                if [(t.shape, t.dtype, t.device) for t in saved] != \
                        self.meta:
                    raise RuntimeError(
                        f"the recompute saved {len(saved)} tensors, the "
                        f"forward {len(self.meta)}, or other shapes")
                self.saved = saved
            t, self.saved[i] = self.saved[i], None
            return t


def _detached(node, memo: dict):
    """`node` (tensors in lists and tuples) with each tensor detached once,
    keeping whether it requires grad and which entries are one tensor."""
    if isinstance(node, Tensor):
        if id(node) not in memo:
            memo[id(node)] = node.detach().requires_grad_(node.requires_grad)
        return memo[id(node)]
    if isinstance(node, (list, tuple)):
        return type(node)(_detached(v, memo) for v in node)
    return node


def remat(cfg: ModelConfig, fn, *args):
    """``layers.remat`` for a region spanning the mesh's cards: fn(*args),
    its saved tensors recomputed in the backward pass when cfg.remat is not
    "none" and autograd records (:class:`_Recompute`).  The per-rank
    regions inside it (attention's q-chunks, the SSM's chunks) keep
    ``torch.utils.checkpoint``."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    region = _Recompute(fn, args)
    with torch.autograd.graph.saved_tensors_hooks(region.pack,
                                                  region.unpack):
        return fn(*args)


def _split(spec, policy) -> Tuple[Optional[int], Optional[int]]:
    """(the dimension split over the model axis, the one split over the
    data axes), None for neither, of a per-layer spec."""
    tp_dim = dp_dim = None
    dp = tuple(policy.dp_axes)
    for i, entry in enumerate(spec):
        names = entry if isinstance(entry, tuple) else \
            (() if entry is None else (entry,))
        if not names:
            continue
        if names == (policy.tp_axis,):
            tp_dim = i
        elif names == dp:
            dp_dim = i
        else:
            raise NotImplementedError(
                f"spec {spec}: a dimension over {names}; the executor "
                f"splits one over {policy.tp_axis!r} and one over {dp}")
    return tp_dim, dp_dim


class _Ranked(list):
    """One value a rank: a placed leaf in a parameter tree."""


def _pick(tree, r: int):
    if isinstance(tree, _Ranked):
        return tree[r]
    if isinstance(tree, dict):
        return {k: _pick(v, r) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, r) for v in tree]
    return tree


def _wrap(node, made: dict, trainable: bool):
    """`node` (a placed tree) with each distinct tensor one
    ``nn.Parameter`` (`made`: by the tensor's id).  Module-level: a nested
    function that calls itself is a reference cycle, which would hold the
    Parameters after their model is dropped, until the garbage collector
    runs."""
    if isinstance(node, _Ranked):
        return _Ranked(made.setdefault(id(t), torch.nn.Parameter(
            t, requires_grad=trainable)) for t in node)
    if isinstance(node, dict):
        return {k: _wrap(v, made, trainable) for k, v in node.items()}
    if isinstance(node, list):
        return [_wrap(v, made, trainable) for v in node]
    return node


def _identity(a):
    """A key equal for two views of the same elements: a tensor's address,
    shape, strides, dtype and device, any other object's id."""
    if isinstance(a, Tensor):
        return (a.data_ptr(), tuple(a.shape), a.stride(), a.dtype, a.device)
    return id(a)


# torch dtypes by the reference's HLO names (runtime/hlo.py's table)
_HLO_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16",
               torch.float16: "f16", torch.float64: "f64",
               torch.int8: "s8", torch.uint8: "u8", torch.int16: "s16",
               torch.int32: "s32", torch.int64: "s64", torch.bool: "pred",
               torch.float8_e4m3fn: "f8e4m3fn", torch.float8_e5m2: "f8e5m2"}
# the collective each one's backward runs
_DUAL = {"all-gather": "reduce-scatter", "all-reduce": "all-reduce"}


def _attr(module, name: str):
    return reduce(getattr, name.split("."), module)


class Placement:
    """The executor of a policy's placement over its mesh (module
    docstring).  ``devices[r]`` is rank r's device, r = d * tp + m for
    data index d and model index m."""

    def __init__(self, cfg: ModelConfig, policy):
        from repro_torch.models.registry import build_model  # cycle
        self.cfg, self.policy = cfg, policy
        mesh = policy.mesh
        names = list(mesh.axis_names)
        order = [names.index(a) for a in policy.dp_axes] \
            + [names.index(policy.tp_axis)]
        rest = [i for i in range(len(names)) if i not in order]
        if any(mesh.devices.shape[i] != 1 for i in rest):
            raise ValueError(f"mesh {mesh}: an axis that is neither data "
                             f"{policy.dp_axes} nor model "
                             f"{policy.tp_axis!r} has size > 1")
        grid = np.transpose(mesh.devices, order + rest).reshape(
            policy.dp_size, policy.tp_size)
        self.dp, self.tp = grid.shape
        self.devices: List[torch.device] = list(grid.reshape(-1))
        self.p = len(self.devices)
        shapes = build_model(cfg).init_shapes()
        self.splits: Dict[str, Tuple[Optional[int], Optional[int]]] = {}
        for path, s in policy.params_specs(cfg, shapes).items():
            self.splits[path] = _split(s[1:] if "blocks" in path else s,
                                       policy)
        self.timer: Optional[list] = None
        self.recorder: Optional[list] = None
        self.meter = None
        self._plans: Dict[Any, Any] = {}

    # --- ranks --------------------------------------------------------------

    def group(self, d: int) -> range:
        """The ranks of data group d, by model index."""
        return range(d * self.tp, (d + 1) * self.tp)

    def tp_dim(self, path: str) -> Optional[int]:
        """The dimension of a per-layer leaf (reference path) split over
        the model axis, or None."""
        return self.splits[path][0]

    def cached_plan(self, key, make):
        """A per-placement constant (a layer's head plan), made once."""
        if key not in self._plans:
            self._plans[key] = make()
        return self._plans[key]

    # --- parameters ---------------------------------------------------------

    def _tp_piece(self, path: str, t: Tensor, dim: int, m: int) -> Tensor:
        if path.endswith("ssm/in_proj"):   # [x | z]: x and z columns of m
            di = t.shape[1] // 2
            if di % self.tp:
                raise ValueError(f"{path}: d_inner {di} does not split "
                                 f"over the model axis of {self.tp}")
            w = di // self.tp
            return torch.cat([t[:, m * w:(m + 1) * w],
                              t[:, di + m * w:di + (m + 1) * w]], dim=1)
        size = t.shape[dim] // self.tp
        return t.narrow(dim, m * size, size)

    def key(self, path: str, r: int) -> Tuple[int, int]:
        """Which piece of a per-layer leaf rank r holds: (its data index,
        its model index), -1 where the leaf is whole over that axis."""
        tp_dim, dp_dim = self.splits[path]
        d, m = divmod(r, self.tp)
        return (d if dp_dim is not None else -1,
                m if tp_dim is not None else -1)

    def piece(self, path: str, t: Tensor, key: Tuple[int, int]) -> Tensor:
        """The piece `key` (``key``) of a whole per-layer leaf `t`, in
        place where it is a contiguous cut."""
        tp_dim, dp_dim = self.splits[path]
        d, m = key
        if d >= 0:
            size = t.shape[dp_dim] // self.dp
            t = t.narrow(dp_dim, d * size, size)
        if m >= 0:
            t = self._tp_piece(path, t, tp_dim, m)
        return t

    def cut(self, path: str, t: Tensor) -> _Ranked:
        """The rank shards of one per-layer leaf (reference path `path`),
        each a new tensor on its rank's device; ranks of one card share a
        shard that is the same piece, ranks on the CPU do not (module
        docstring)."""
        made: dict = {}
        out = _Ranked()
        for r, dev in enumerate(self.devices):
            key = self.key(path, r)
            home = (dev if dev.type != "cpu" else r,) + key
            if home not in made:
                piece = self.piece(path, t, key)
                made[home] = torch.empty(piece.shape, dtype=piece.dtype,
                                         device=dev).copy_(piece)
            out.append(made[home])
        return out

    def whole(self, path: str, pieces: list, device="cpu") -> Tensor:
        """One per-layer leaf of its rank pieces (``cut``'s inverse), on
        `device`."""
        tp_dim, dp_dim = self.splits[path]
        return self._join(pieces, tp_dim, dp_dim, device,
                          path.endswith("ssm/in_proj"))

    def __call__(self, prefix: str, tree):
        """A parameter (sub)tree at reference path `prefix` with each leaf
        cut into its rank shards (``init_params(place=)``)."""
        if isinstance(tree, dict):
            return {k: self(f"{prefix}/{k}", v) for k, v in tree.items()}
        return self.cut(prefix, tree)

    def build(self, cls, cfg: ModelConfig, tensors: dict,
              trainable: bool = False) -> "ShardedLM":
        """The ranks' modules of class `cls` from a placed tensor tree: one
        ``nn.Parameter`` a distinct shard, held by every rank that reads
        it (requiring grad where `trainable`)."""
        tensors = _wrap(tensors, {}, trainable)
        return ShardedLM(self, [cls(cfg, _pick(tensors, r), trainable)
                                for r in range(self.p)])

    # --- rank-wise compute and collectives ------------------------------------

    def map(self, fn, *lists) -> list:
        """[fn(*args of rank r)], computed once for ranks whose arguments
        are the same elements (replicated values on one device), for each
        rank under a ``meter``.  fn must be a pure function of its
        arguments."""
        if self.meter is not None:
            return [fn(*args) for args in zip(*lists)]
        out, seen = [], {}
        for args in zip(*lists):
            key = tuple(_identity(a) for a in args)
            if key not in seen:
                seen[key] = fn(*args)
            out.append(seen[key])
        return out

    def weighted(self, n: int):
        """Counts the ops inside as the work of n ranks under a ``meter``
        (a shard updated once for the ranks that read it)."""
        return contextlib.nullcontext() if self.meter is None \
            else self.meter.weighted(n)

    def _quiet(self):
        """Leaves a collective's own copies and adds out of the ``meter``'s
        count: ``recorder`` accounts for them."""
        return contextlib.nullcontext() if self.meter is None \
            else self.meter.paused()

    def group_name(self, data: bool = False, model: bool = False) -> str:
        """The axes a collective runs over, comma-joined."""
        return ",".join((tuple(self.policy.dp_axes) if data else ())
                        + ((self.policy.tp_axis,) if model else ()))

    def record(self, kind: str, operand: Tensor, group: str,
               out: Optional[Tensor] = None) -> None:
        """Appends one collective to ``recorder`` when it is a list: its
        kind, `operand`'s dtype and dims (one rank's: the operand bytes a
        device sends, the reference's definition) and the group's axes.
        Under autograd a hook on `out` appends the backward's dual when
        its gradient is computed."""
        if self.recorder is None:
            return
        self._append(kind, operand, group)
        if out is not None and out.requires_grad:
            dual = _DUAL[kind]
            out.register_hook(lambda g: self._append(dual, g, group))

    def _append(self, kind: str, t: Tensor, group: str) -> None:
        if self.recorder is not None:
            self.recorder.append((kind, _HLO_DTYPES.get(t.dtype, "f32"),
                                  ",".join(str(n) for n in t.shape), group))

    @contextlib.contextmanager
    def _span(self, dev: torch.device):
        """Times a collective on `dev`'s stream when ``timer`` is a list
        (CUDA events; nothing on the CPU)."""
        if self.timer is None or dev.type != "cuda":
            yield
            return
        start, end = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        start.record(torch.cuda.current_stream(dev))
        yield
        end.record(torch.cuda.current_stream(dev))
        self.timer.append((start, end))

    def collective_ms(self) -> float:
        """The summed ms of the collectives timed since ``timer`` was set
        to a list (synchronises the cards)."""
        for dev in dict.fromkeys(self.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return sum(s.elapsed_time(e) for s, e in self.timer or ())

    def all_reduce(self, parts: list, dtype: torch.dtype) -> list:
        """Sum over the model axis: each group's float32 partials summed on
        its first rank's device in rank order, rounded once to `dtype`,
        and copied to every rank of the group."""
        out: list = [None] * self.p
        for d in range(self.dp):
            g = self.group(d)
            owner = self.devices[g[0]]
            with self._span(owner), self._quiet():
                total = parts[g[0]]
                for r in g[1:]:
                    total = total + parts[r].to(owner)
                total = total.to(dtype)
                copies = {owner: total}
                for r in g:
                    dev = self.devices[r]
                    if dev not in copies:
                        copies[dev] = total.to(dev)
                    out[r] = copies[dev]
        if self.tp > 1:
            self.record("all-reduce", parts[0], self.group_name(model=True),
                        out[0])
        return out

    def all_gather(self, parts: list, dim: int) -> list:
        """Concatenation over the model axis: each rank gets its group's
        pieces in rank order along `dim` (once a device)."""
        out: list = [None] * self.p
        for d in range(self.dp):
            g = self.group(d)
            with self._span(self.devices[g[0]]), self._quiet():
                made: dict = {}
                for r in g:
                    dev = self.devices[r]
                    if dev not in made:
                        made[dev] = torch.cat(
                            [parts[q].to(dev) for q in g], dim) \
                            if self.tp > 1 else parts[r]
                    out[r] = made[dev]
        if self.tp > 1:
            self.record("all-gather", parts[0], self.group_name(model=True),
                        out[0])
        return out

    def gather_data(self, parts: list, dim: int = 0) -> list:
        """Concatenation over the data axis: rank (d, m) gets the pieces of
        ranks (0, m), (1, m), ... along `dim`."""
        if self.dp == 1:
            return list(parts)
        out: list = [None] * self.p
        made: dict = {}
        for r, dev in enumerate(self.devices):
            col = [parts[d * self.tp + r % self.tp] for d in range(self.dp)]
            key = (dev,) + tuple(id(t) for t in col)
            if key not in made:
                with self._span(dev), self._quiet():
                    made[key] = torch.cat([t.to(dev) for t in col], dim)
            out[r] = made[key]
        self.record("all-gather", parts[0], self.group_name(data=True),
                    out[0])
        return out

    # --- inputs and outputs ---------------------------------------------------

    def batch_split(self, batch: int) -> bool:
        """Whether a batch splits over the data axes (``batch_spec``, where
        the size divides, as ``cache_specs`` places the caches)."""
        return self.dp > 1 and self.policy._div(batch, self.dp)

    def scatter(self, t: Optional[Tensor], split: bool) -> list:
        """A batch-major input on every rank: its rows split over the data
        axes where `split` (``batch_split`` of its batch), whole
        otherwise."""
        if t is None:
            return [None] * self.p
        n = t.shape[0] // self.dp if split else t.shape[0]
        made: dict = {}
        out = []
        for r, dev in enumerate(self.devices):
            d = r // self.tp if split else 0
            if (dev, d) not in made:
                made[dev, d] = t.narrow(0, d * n, n).to(dev)
            out.append(made[dev, d])
        return out

    def collect(self, parts: list, split: bool) -> Tensor:
        """A batch-major result on the first rank's device: the data
        groups' rows (each group's first rank's) concatenated where its
        batch was `split`."""
        if not split:
            return parts[0]
        dev = self.devices[0]
        return torch.cat([parts[d * self.tp].to(dev)
                          for d in range(self.dp)], 0)

    def new_caches(self, cache_meta) -> "ShardedCache":
        """Zeroed decode caches placed as ``cache_specs`` places the
        one-device structure `cache_meta` (meta tensors): KV heads over the
        model axis, or with ``kv_cache_shard="sequence"`` the cache's slots
        where the axis divides them (each rank a contiguous slice of
        positions, every KV head); one cache structure a rank at its
        local shapes."""
        specs = self.policy.cache_specs(self.cfg, cache_meta)

        def walk(node, spec, r):
            if isinstance(node, dict):
                return {k: walk(v, spec[k], r) for k, v in node.items()}
            if isinstance(node, list):
                return [walk(v, s, r) for v, s in zip(node, spec)]
            tp_dim, dp_dim = _split(spec, self.policy)
            shape = list(node.shape)
            if tp_dim is not None:
                shape[tp_dim] //= self.tp
            if dp_dim is not None:
                shape[dp_dim] //= self.dp
            return torch.zeros(shape, dtype=node.dtype,
                               device=self.devices[r])
        return ShardedCache(self, [walk(cache_meta, specs, r)
                                   for r in range(self.p)], specs)

    def unshard(self, pieces: list, spec, device="cpu") -> Tensor:
        """One tensor of the rank pieces of a leaf placed by `spec`
        (contiguous cuts), on `device`."""
        return self._join(pieces, *_split(spec, self.policy), device)

    def _join(self, pieces: list, tp_dim, dp_dim, device,
              xz: bool = False) -> Tensor:
        rows = []
        for d in range(self.dp if dp_dim is not None else 1):
            g = [pieces[d * self.tp + m].to(device)
                 for m in range(self.tp if tp_dim is not None else 1)]
            if tp_dim is None:
                rows.append(g[0])
            elif xz:        # each piece [x_m | z_m]: x columns, then z's
                halves = [t.chunk(2, dim=1) for t in g]
                rows.append(torch.cat([h[0] for h in halves]
                                      + [h[1] for h in halves], 1))
            else:
                rows.append(torch.cat(g, tp_dim))
        return torch.cat(rows, dp_dim) if dp_dim is not None else rows[0]


class _AtUse(Mapping):
    """A rank's sub-layer whose FSDP-split leaves are gathered over the
    data axes at each read (ZeRO-3's gather at use); the gathered tensor
    is dropped with its last reference."""

    def __init__(self, sm: "ShardedLM", r: int, name: str):
        self.sm, self.r, self.name = sm, r, name
        self.local = _attr(sm.ranks[r], name)

    def __getitem__(self, key: str) -> Tensor:
        return self.sm.leaf(self.r, f"{self.name}.{key}")

    def __iter__(self):
        return iter(self.local.keys())

    def __len__(self) -> int:
        return len(self.local)

    def __contains__(self, key) -> bool:
        return key in self.local


@dataclasses.dataclass
class Shard:
    """One distinct piece of a leaf over the mesh: the leaf `name` (a port
    name, "blocks.3.attn.wq"), which piece (``Placement.key``), and its
    copies, one a card (a rank on the CPU) that reads it (``copies[i]`` an
    ``nn.Parameter``, ``ranks[i]`` the ranks that read it)."""
    name: str
    key: Tuple[int, int]
    copies: list
    ranks: list


class ShardedLM:
    """A model's parameters placed over a mesh: ``ranks[r]`` is rank r's
    module (a ``DecoderLM`` or ``EncDecLM``) holding its shards, ``px`` the
    :class:`Placement`.  The trunks' ``forward`` / ``decode`` run it
    through the layers' tensor-parallel forms.  ``shards`` lists each
    distinct piece of each leaf once, in the reference's leaf order, and
    ``copies`` their tensors, shard by shard: what AdamW, the global norm
    and the checkpoint visit."""

    def __init__(self, placement: Placement, ranks: list):
        self.px, self.ranks = placement, ranks
        self.cfg = placement.cfg
        # leaves split over the data axes are gathered at each read
        self._fsdp = placement.dp > 1 and any(
            dp is not None for _, dp in placement.splits.values())
        self._parts: dict = {}
        by: dict = {}
        for r, module in enumerate(ranks):
            for name, t in named_leaves(module):
                key = placement.key(reference_path(name)[0], r)
                sh = by.setdefault((name, key), Shard(name, key, [], []))
                i = next((i for i, c in enumerate(sh.copies) if c is t),
                         None)
                if i is None:
                    sh.copies.append(t)
                    sh.ranks.append([r])
                else:
                    sh.ranks[i].append(r)
        self.shards: List[Shard] = sorted(
            by.values(), key=lambda sh: (order_key(sh.name), sh.key))
        self.copies: List[Tensor] = [c for sh in self.shards
                                     for c in sh.copies]
        self._readers = [len(rs) for sh in self.shards for rs in sh.ranks]
        self._slot = {}        # (leaf name, rank) -> index in copies
        i = 0
        for sh in self.shards:
            for rs in sh.ranks:
                for r in rs:
                    self._slot[sh.name, r] = i
                i += 1

    @property
    def policy(self):
        return self.px.policy

    # --- the distinct shards ----------------------------------------------

    def named_copies(self) -> List[Tuple[str, Tensor]]:
        """(leaf name, tensor) of every copy of every shard, in ``copies``
        order."""
        return [(sh.name, c) for sh in self.shards for c in sh.copies]

    def parameters(self):
        return iter(self.copies)

    def weighted(self, i: int):
        """``Placement.weighted`` for copy i: the ranks that read it."""
        return self.px.weighted(self._readers[i])

    def firsts(self) -> List[int]:
        """The index in ``copies`` of each shard's first copy."""
        out, i = [], 0
        for sh in self.shards:
            out.append(i)
            i += len(sh.copies)
        return out

    def sum_copies(self, grads: list) -> list:
        """Gradients one a copy (``copies`` order), each copy's partial sum
        of its shard's gradient, made each shard's whole gradient on every
        copy: the copies' partials added in copy order on the first copy's
        device, the float32 sum copied to the others, so that the copies of
        a shard stay bitwise equal through the same update."""
        out, i, seen = list(grads), 0, set()
        for sh in self.shards:
            n = len(sh.copies)
            d, m = sh.key
            over = (d < 0 and self.px.dp > 1, m < 0 and self.px.tp > 1)
            if any(over) and sh.name not in seen:   # one record a leaf
                seen.add(sh.name)
                self.px.record("all-reduce", grads[i],
                               self.px.group_name(*over))
            if n > 1:
                dev = sh.copies[0].device
                with self.px._span(dev), self.px._quiet():
                    total = grads[i]
                    for g in grads[i + 1:i + n]:
                        total = total + g.to(dev)
                    out[i:i + n] = [total] + [total.to(c.device)
                                              for c in sh.copies[1:]]
            i += n
        return out

    def whole(self, name: str, per_copy: list, device="cpu") -> Tensor:
        """The whole leaf `name` of tensors one a copy (the parameters, a
        moment: ``copies`` order), assembled on `device`."""
        pieces = [per_copy[self._slot[name, r]] for r in range(self.px.p)]
        return self.px.whole(reference_path(name)[0], pieces, device)

    @torch.no_grad()
    def load(self, name: str, whole: Tensor, per_copy: list) -> None:
        """Writes the whole leaf `name` into its copies' tensors of
        `per_copy` (``copies`` order), in place: the leaf copied once to
        the first rank's device and cut there."""
        path, i = reference_path(name)[0], 0
        whole = whole.to(self.px.devices[0])
        for sh in self.shards:
            if sh.name == name:
                piece = self.px.piece(path, whole, sh.key)
                for t in per_copy[i:i + len(sh.copies)]:
                    if t.shape != piece.shape or t.dtype != piece.dtype:
                        raise ValueError(
                            f"{name}: the leaf's piece is {piece.dtype} "
                            f"{tuple(piece.shape)}, the shard {t.dtype} "
                            f"{tuple(t.shape)}")
                    t.copy_(piece)
            i += len(sh.copies)

    # --- reads --------------------------------------------------------------

    def leaf(self, r: int, name: str) -> Tensor:
        """Rank r's shard of the leaf `name` ("blocks.3.attn.wq") over the
        model axis: gathered over the data axes where FSDP splits it."""
        px = self.px
        local = _attr(self.ranks[r], name)
        dp_dim = px.splits[reference_path(name)[0]][1]
        if dp_dim is None or px.dp == 1:
            return local
        m, dev = r % px.tp, px.devices[r]
        with px._span(dev), px._quiet():
            out = torch.cat([_attr(self.ranks[d * px.tp + m], name).to(dev)
                             for d in range(px.dp)], dp_dim)
        if r == 0:      # one record a use: rank 0's gather
            px.record("all-gather", local, px.group_name(data=True), out)
        return out

    def parts(self, name: str) -> list:
        """Every rank's `name`: a sub-layer (a mapping of its leaves) or a
        leaf; FSDP-split leaves are gathered at each read."""
        if not self._fsdp:
            if name not in self._parts:
                self._parts[name] = [_attr(m, name) for m in self.ranks]
            return self._parts[name]
        out = []
        for r, m in enumerate(self.ranks):
            node = _attr(m, name)
            out.append(self.leaf(r, name) if isinstance(node, Tensor)
                       else _AtUse(self, r, name))
        return out


@dataclasses.dataclass
class ShardedCache:
    """Decode caches over a mesh: ``ranks[r]`` is rank r's cache in the
    one-device structure at its local shapes, ``specs`` the specs of the
    one-device structure (``ShardingPolicy.cache_specs``)."""
    px: Placement
    ranks: list
    specs: Any

    def by_positions(self, run: Optional[int] = None) -> bool:
        """Whether the KV caches of a run (of the one dict of an
        encoder-decoder's cache when None) are split over the model axis
        by slots (sequence mode), not by heads."""
        node = self.specs if run is None else self.specs[run]
        return "k" in node and _split(node["k"], self.px.policy)[0] == 3

    def assemble(self, device="cpu"):
        """The one-device cache structure of the ranks' pieces."""
        def walk(spec, pieces):
            if isinstance(spec, dict):
                return {k: walk(spec[k], [p[k] for p in pieces])
                        for k in spec}
            if isinstance(spec, list):
                return [walk(s, [p[i] for p in pieces])
                        for i, s in enumerate(spec)]
            return self.px.unshard(pieces, spec, device)
        return walk(self.specs, self.ranks)


@dataclasses.dataclass
class Out:
    """A layer's output on every rank: ``partial`` float32 terms of a sum
    over the model axis, or the whole output (``partial`` False)."""
    parts: list
    partial: bool


def combine(px: Placement, outs: List[Out], dtype: torch.dtype) -> list:
    """The sum of layer outputs on every rank: the partial ones added in
    float32 and all-reduced once, rounded to `dtype`, then the whole
    ones added (a hybrid layer's attention and SSM)."""
    partial = [o.parts for o in outs if o.partial]
    whole = [o.parts for o in outs if not o.partial]
    total = None
    if partial:
        total = px.all_reduce(
            [reduce(torch.add, ps) for ps in zip(*partial)], dtype)
    for parts in whole:
        total = parts if total is None else px.map(torch.add, total, parts)
    return total


__all__ = ["Placement", "Shard", "ShardedLM", "ShardedCache", "Out",
           "combine", "mm32", "remat"]
