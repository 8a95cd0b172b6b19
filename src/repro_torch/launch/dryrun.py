"""Multi-pod dry run: every (arch x shape x mesh) cell's step run on the
meta device over the production mesh.

Counterpart of ``repro/launch/dryrun.py``, which proves each cell with
``jit(...).lower().compile()``.  The port compiles nothing: it runs the
real step functions (``models/steps.py``: train with AdamW, prefill into a
cache of the cell's length, decode) over ``launch.mesh.
make_production_mesh``, (16, 16) ("data", "model") or (2, 16, 16) ("pod",
"data", "model") logical ranks on ``torch.device("meta")``.  These entry
points run on no device, on purpose: that is what lets a 340B-parameter
cell be checked on one host.  It is not a CPU fallback.  For each cell, WITHOUT
allocating any model-sized tensor:

  * proof the sharded step composes on the production mesh: every shape
    of every rank's op fits, or the cell fails;
  * FLOPs by ``torch.utils.flop_counter``'s formulas (``flop_registry``,
    those ``FlopCounterMode`` applies), bytes by a ``TorchDispatchMode``
    (:class:`Meter`) that sums each op's input and output bytes, and the
    peak of live bytes;
  * the collectives the executor runs, from ``Placement.recorder``
    (``runtime/hlo.py``).

An op counts once for every rank whose result it is: under the meter
``Placement.map`` computes for each rank, and a shard that AdamW updates
once for the ranks reading it counts as their work
(``Placement.weighted``).

Results are cached as JSON under experiments/torch/dryrun/, so repeated
invocations only run missing cells; launch/roofline.py and launch/report.py
read them.  A record keeps the reference's keys, so both packages' records
compare cell by cell and ``report`` reads either:

  * ``arch``, ``shape``, ``kind``, ``mesh`` (the reference's description),
    ``chips`` (ranks), ``params``, ``active_params``, ``seq``, ``batch``,
    ``label``: as the reference's;
  * ``lower_s``: seconds to place the cell's parameters, optimizer state,
    inputs and caches on the meta ranks; ``compile_s``: seconds of the meta
    run of the step;
  * ``cost.flops``: the per-device mean of the FLOP count (matrix products
    and attention, as ``FlopCounterMode`` counts them; elementwise ops add
    none); ``cost["bytes accessed"]``: the per-device mean of the
    dispatch mode's bytes (view ops move none);
  * ``memory.argument_size_in_bytes``: the largest rank's parameter,
    optimizer-state, input and cache bytes (the decode cell's
    ``cache_index`` as the reference's int32 scalar);
    ``memory.output_size_in_bytes``: the largest rank's bytes of the
    step's results; ``memory.temp_size_in_bytes``: the meta run's peak of
    live bytes (storages counted when an op creates them and dropped by
    ``weakref.finalize``) divided by the ranks;
  * ``collectives``: ``bytes_by_kind``, ``count_by_kind``, ``total_bytes``
    (one rank's operand bytes per collective, the reference's definition)
    and the first 20 ``redundant`` signatures;
  * ``op_histogram``: the 20 most frequent aten ops (the reference's
    ``hlo.op_histogram`` of HLO op names).

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k [--multi-pod]
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--arch-filter moe]
  python -m repro_torch.launch.dryrun --pcc artificial_64k [--multi-pod]
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import get_config, list_archs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import steps as model_steps
from repro_torch.models.config import (SHAPES, cache_specs, input_specs,
                                       specs_at)
from repro_torch.models.parallel import Placement, ShardedCache, ShardedLM
from repro_torch.models.registry import build_model
from repro_torch.models.sharding import make_policy
from repro_torch.optim import adamw
from repro_torch.runtime import hlo

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "experiments", "torch", "dryrun")


class Meter(TorchDispatchMode):
    """Counts every aten op on meta tensors dispatched while it is active
    (the host's index arithmetic is left out): FLOPs by
    ``flop_registry`` (``FlopCounterMode``'s formulas), bytes (each
    tensor input's and output's; a view's none), op names, and the live
    bytes of the storages ops create (not those of `held`, the step's
    arguments), with their peak.  ``weighted(n)`` counts a region as n
    ranks' work; ``paused()`` leaves a region out of the counts (a
    collective's own copies, which ``Placement.recorder`` accounts)."""

    def __init__(self, held=()):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops: collections.Counter = collections.Counter()
        self.weight = 1
        self.quiet = 0
        self.held = {t.untyped_storage()._cdata for t in held}
        self.live: dict = {}
        self.live_bytes = 0
        self.peak = 0
        self._fast: dict = {}

    @contextlib.contextmanager
    def weighted(self, n: int):
        old, self.weight = self.weight, self.weight * n
        try:
            yield
        finally:
            self.weight = old

    @contextlib.contextmanager
    def paused(self):
        self.quiet += 1
        try:
            yield
        finally:
            self.quiet -= 1

    def _free(self, key: int, nbytes: int) -> None:
        if self.live.pop(key, None) is not None:
            self.live_bytes -= nbytes

    def _run(self, func, args, kwargs):
        """func on meta tensors.  A pointwise op's result is made here:
        the broadcast shape, in the dtype the op gives one-element CPU
        stand-ins (contiguous; an in-place op returns its first input).
        torch's own meta kernels for them are Python references, some
        hundred microseconds an op, which over 256 ranks dominated a
        cell's run."""
        fast = self._fast.get(func)
        if fast is None:
            fast = self._fast[func] = (
                torch.Tag.pointwise in func.tags
                and len(func._schema.returns) == 1,
                any(r.alias_info is not None and r.alias_info.is_write
                    for r in func._schema.returns))
        if fast[0]:
            tensors = _tensors(args, kwargs)
            if tensors and all(t.is_meta for t in tensors):
                dtype = func(*_stand_ins(args),
                             **dict(zip(kwargs, _stand_ins(kwargs.values())))
                             ).dtype
                if fast[1]:
                    return args[0]
                return torch.empty(
                    torch.broadcast_shapes(*(t.shape for t in tensors)),
                    dtype=dtype, device="meta")
        return func(*args, **kwargs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self._run(func, args, kwargs)
        outs, ins = _tensors((out,), {}), _tensors(args, kwargs)
        if not any(t.is_meta for t in ins + outs):
            return out      # the host's index arithmetic
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key not in self.live and key not in self.held:
                nb = st.nbytes()
                self.live[key] = nb
                self.live_bytes += nb
                self.peak = max(self.peak, self.live_bytes)
                weakref.finalize(st, self._free, key, nb)
        if self.quiet:
            return out
        w = self.weight
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += w * int(flop_registry[packet](*args, **kwargs,
                                                        out_val=out))
        if not func.is_view:
            self.bytes += w * sum(t.numel() * t.element_size()
                                  for t in ins + outs)
        self.ops[packet] += w
        return out


def _tensors(args, kwargs) -> list:
    """The tensors among an op's arguments (or results), a list of them
    (``cat``'s) included."""
    out = []
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(t for t in a if isinstance(t, torch.Tensor))
    return out


def _stand_ins(values) -> list:
    """`values` with each tensor a one-element CPU tensor of its dtype and
    rank (the op's type promotion, which tells 0-dim operands apart)."""
    return [torch.ones((1,) * a.ndim, dtype=a.dtype)
            if isinstance(a, torch.Tensor) else a for a in values]


def describe(mesh) -> str:
    """The reference's description of a mesh ("Mesh(data=16 x model=16;
    256 devices)"): one device a rank."""
    dims = " x ".join(f"{n}={s}" for n, s in mesh.shape.items())
    return f"Mesh({dims}; {mesh.size} devices)"


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _rank_bytes(tensors) -> int:
    """Bytes of distinct storages among `tensors`."""
    seen: dict = {}
    for t in tensors:
        seen.setdefault(t.untyped_storage()._cdata, _nbytes(t))
    return sum(seen.values())


def _copies_of(sm: ShardedLM) -> list:
    """The indices in ``sm.copies`` each rank reads."""
    out: list = [[] for _ in range(sm.px.p)]
    i = 0
    for sh in sm.shards:
        for rs in sh.ranks:
            for r in rs:
                out[r].append(i)
            i += 1
    return out


def _rank_tensors(sm: ShardedLM, nodes) -> list:
    """Each rank's tensors among `nodes`: the shards of a placed model
    (``sm``) it reads, an AdamW state's moments of those and its step, its
    pieces of a cache; any other tensor on the first rank (logits,
    metrics)."""
    px, copies = sm.px, _copies_of(sm)
    per: list = [[] for _ in range(px.p)]
    for node in nodes:
        for r in range(px.p):
            if isinstance(node, ShardedLM):
                per[r] += [node.copies[i] for i in copies[r]]
            elif isinstance(node, ShardedCache):
                per[r] += tree_leaves(node.ranks[r])
            elif isinstance(node, dict) and "m" in node and "v" in node:
                per[r] += [node[k][i] for k in ("m", "v")
                           for i in copies[r]] + [node["step"]]
            elif r == 0:
                per[r] += [t for t in tree_leaves(node)
                           if isinstance(t, torch.Tensor)]
    return per


def _per_rank(args, kwargs) -> list:
    """Each rank's argument tensors: its parameter shards, their AdamW
    moments and step, its cache pieces (and the reference's int32
    ``cache_index``) and its rows of each batch-major input (whole where
    the batch does not split over data)."""
    sm = args[0]
    px = sm.px
    cache = kwargs.get("cache")
    out = _rank_tensors(sm, args + ((cache,) if cache is not None else ()))
    if cache is not None:
        index = torch.empty((), dtype=torch.int32, device="meta")
        for ts in out:
            ts.append(index)
    batch = [v for v in kwargs.values() if isinstance(v, torch.Tensor)
             and v.ndim > 0]
    split = bool(batch) and px.batch_split(batch[0].shape[0])
    for v in batch:
        piece = v.narrow(0, 0, v.shape[0] // px.dp) if split else v
        for ts in out:
            ts.append(piece)
    return out


def build_cell(arch: str, shape: str, multi_pod: bool, cfg_transform=None,
               *, mesh=None, dims=None):
    """Returns (step_fn, args, kwargs, static_info): the cell's step as the
    reference builds it (train with AdamW, prefill into a cache of the
    cell's length, decode) under the policy of the production mesh, its
    parameters placed from the meta shapes by ``Placement`` (no generator:
    none exists on the meta device), their AdamW state, the inputs of
    ``input_specs`` and a decode cell's ``cache_specs`` cache placed as the
    policy says; ``step_fn(*args, **kwargs)`` runs it.  cfg_transform: an
    optional ModelConfig -> ModelConfig hook (the roofline's analysis
    variant).  ``mesh`` (of meta ranks) replaces the production mesh and
    ``dims`` = (seq, batch, kind) the shape's: a cut-down cell, whose
    predicted bytes a card's run can be held to."""
    mesh = make_production_mesh(multi_pod=multi_pod) if mesh is None \
        else mesh
    cfg = get_config(arch)
    if cfg_transform is not None:
        cfg = cfg_transform(cfg)
    policy = make_policy(cfg, mesh)
    model = build_model(cfg)
    seq, batch, kind = SHAPES[shape] if dims is None else dims
    px = Placement(cfg, policy)
    params = model.trunk.init_params(None, cfg, "meta",
                                     trainable=kind == "train", place=px)

    kwargs = {}
    specs = input_specs(cfg, shape) if dims is None else \
        specs_at(cfg, seq, batch, kind)
    for k, v in specs.items():
        if k == "cache":
            kwargs["cache"] = px.new_caches(cache_specs(cfg, batch, seq))
        elif k == "cache_index":
            kwargs["cache_index"] = seq - 1
        else:
            kwargs[k] = v

    info = {"arch": arch, "shape": shape, "kind": kind,
            "mesh": describe(mesh), "chips": int(mesh.size),
            "params": model.param_count(),
            "active_params": model.active_param_count(),
            "seq": seq, "batch": batch}

    if kind == "train":
        opt_cfg = adamw.AdamWConfig(moment_dtype=cfg.opt_state_dtype)
        opt_state = adamw.init(opt_cfg, params)
        fn = model_steps.make_train_step(cfg, opt_cfg, policy=policy)
        args = (params, opt_state)
    elif kind == "prefill":
        fn = model_steps.make_prefill_step(cfg, policy=policy,
                                           cache_capacity=seq)
        args = (params,)
    else:  # decode
        fn = model_steps.make_decode_step(cfg, policy=policy)
        args = (params,)
    return fn, args, kwargs, info


def argument_bytes(args, kwargs) -> int:
    """``memory.argument_size_in_bytes`` of a built cell: the largest
    rank's parameter, optimizer-state, input and cache bytes."""
    return max(_rank_bytes(ts) for ts in _per_rank(args, kwargs))


def measure(fn, args, kwargs) -> dict:
    """Runs a built cell's step on the meta ranks under a :class:`Meter`
    and ``Placement.recorder``.  Returns the per-device means of its FLOPs
    and bytes, the memory fields, its collectives' stats, the op counts and
    the run's seconds."""
    px: Placement = args[0].px
    per_rank = _per_rank(args, kwargs)
    held = [t for ts in per_rank for t in ts]
    meter = Meter(held)
    px.recorder, px.meter = [], meter
    t0 = time.time()
    try:
        with meter:
            result = fn(*args, **kwargs)
    finally:
        records, px.recorder, px.meter = px.recorder, None, None
    seconds = time.time() - t0
    stats = hlo.collective_stats(records)
    return {
        "flops": meter.flops / px.p,
        "bytes": meter.bytes / px.p,
        "memory": {
            "argument_size_in_bytes": max(_rank_bytes(ts)
                                          for ts in per_rank),
            "output_size_in_bytes": max(
                _rank_bytes(ts) for ts in _rank_tensors(args[0], result)),
            "temp_size_in_bytes": meter.peak // px.p,
        },
        "stats": stats,
        "ops": meter.ops,
        "seconds": seconds,
    }


def run_cell(arch: str, shape: str, multi_pod: bool,
             save: bool = True) -> dict:
    label = f"{arch}__{shape}__{'pod2' if multi_pod else 'pod1'}"
    t0 = time.time()
    fn, args, kwargs, info = build_cell(arch, shape, multi_pod)
    t_lower = time.time() - t0
    m = measure(fn, args, kwargs)
    del fn, args, kwargs

    rec = dict(info)
    rec["label"] = label
    rec["lower_s"] = round(t_lower, 2)
    rec["compile_s"] = round(m["seconds"], 2)
    rec["cost"] = {"flops": float(m["flops"]),
                   "bytes accessed": float(m["bytes"])}
    rec["memory"] = m["memory"]
    stats = m["stats"]
    rec["collectives"] = {
        "bytes_by_kind": stats.bytes_by_kind,
        "count_by_kind": stats.count_by_kind,
        "total_bytes": stats.total_bytes,
        "redundant": stats.redundant[:20],
    }
    rec["op_histogram"] = hlo.op_histogram(
        {str(k): v for k, v in m["ops"].items()})
    print(f"[dryrun] {label}: run={rec['compile_s']:.1f}s "
          f"flops={rec['cost']['flops']:.3e} "
          f"coll={stats.total_bytes/2**30:.3f}GiB "
          f"({stats.total_count} ops)")
    if save:
        os.makedirs(RESULTS_DIR, exist_ok=True)
        with open(os.path.join(RESULTS_DIR, label + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def run_pcc(dataset: str, multi_pod: bool, save: bool = True) -> dict:
    """Dry run of the paper's own workload, distributed triangular PCC over
    the production mesh's ranks: the reference's analytic fields (tiles a
    device, the pass, the kernel's FLOPs and operand bytes a pass), from
    the port's plan (``core.plan.tiles_per_device``) and
    ``configs.lightpcc.flops``.  It launches no kernel.  Memory a device:
    the replicated transformed operand (argument) and the executor's two
    live pass buffers (temp); no collective (each rank's tiles reach the
    sink as its own pieces)."""
    from repro_torch.configs import lightpcc
    from repro_torch.core import tiling
    from repro_torch.core.plan import tiles_per_device

    pcc_cfg = {c.name: c for t in lightpcc.TABLES.values()
               for c in t}[dataset]
    mesh = make_production_mesh(multi_pod=multi_pod)
    p = int(mesh.size)
    t0 = time.time()
    plan = tiling.TilePlan.create(pcc_cfg.n, pcc_cfg.l, pcc_cfg.t)
    l_pad = -(-pcc_cfg.l // pcc_cfg.l_blk) * pcc_cfg.l_blk
    per_dev = tiles_per_device(plan.total_tiles, p)
    pass_tiles = min(per_dev, pcc_cfg.max_tiles_per_pass)
    label = f"lightpcc-{dataset}__allpairs__{'pod2' if multi_pod else 'pod1'}"
    flops = pass_tiles * pcc_cfg.t * pcc_cfg.t * 2 * l_pad
    hbm = pass_tiles * (2 * pcc_cfg.t * l_pad + pcc_cfg.t * pcc_cfg.t) * 4
    pass_buffer = pass_tiles * pcc_cfg.t * pcc_cfg.t * 4
    rec = {
        "label": label, "arch": f"lightpcc-{dataset}", "shape": "allpairs",
        "kind": "pcc", "mesh": describe(mesh), "chips": p,
        "n": pcc_cfg.n, "l": pcc_cfg.l, "t": pcc_cfg.t,
        "tiles_total": plan.total_tiles, "tiles_per_device": per_dev,
        "pass_tiles": pass_tiles,
        "compile_s": round(time.time() - t0, 2),
        "paper_unit_ops": lightpcc.flops(pcc_cfg),
        # exact analytic kernel cost per device per pass (GEMM tiles):
        # pass_tiles * t^2 * 2*l_pad FLOPs; operands read t*l_pad*2 per tile
        "analytic_flops_per_dev": flops,
        "analytic_hbm_bytes_per_dev": hbm,
        "cost": {"flops": float(flops), "bytes accessed": float(hbm)},
        "memory": {"argument_size_in_bytes": plan.n_pad * l_pad * 4 + 4,
                   "output_size_in_bytes": pass_buffer,
                   "temp_size_in_bytes": 2 * pass_buffer},
        "collectives": {"bytes_by_kind": {}, "count_by_kind": {},
                        "total_bytes": 0},
    }
    print(f"[dryrun] {label}: flops={flops:.3e}")
    if save:
        os.makedirs(RESULTS_DIR, exist_ok=True)
        with open(os.path.join(RESULTS_DIR, label + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--pcc", default=None, help="lightpcc dataset name")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--arch-filter", default="")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()

    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    jobs = []
    if args.pcc:
        for mp in meshes:
            jobs.append(("pcc", args.pcc, mp))
    elif args.all:
        for arch in list_archs():
            if args.arch_filter and args.arch_filter not in arch:
                continue
            cfg = get_config(arch)
            for shape in cfg.shapes:
                for mp in meshes:
                    jobs.append((arch, shape, mp))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all / --pcc) required")
        for mp in meshes:
            jobs.append((args.arch, args.shape, mp))

    os.makedirs(RESULTS_DIR, exist_ok=True)
    failures = []
    for arch, shape, mp in jobs:
        label = (f"lightpcc-{shape}__allpairs__" if arch == "pcc"
                 else f"{arch}__{shape}__") + ("pod2" if mp else "pod1")
        path = os.path.join(RESULTS_DIR, label + ".json")
        if os.path.exists(path) and not args.force:
            print(f"[dryrun] {label}: cached, skipping")
            continue
        try:
            if arch == "pcc":
                run_pcc(shape, mp)
            else:
                run_cell(arch, shape, mp)
        except Exception as e:
            failures.append((label, repr(e)))
            print(f"[dryrun] {label}: FAILED {e!r}")
            traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for lab, e in failures:
            print(f"  {lab}: {e}")
        raise SystemExit(1)
    print("\nall requested dry-run cells ran OK")


if __name__ == "__main__":
    main()
