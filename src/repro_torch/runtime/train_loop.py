"""Fault-tolerant training loop.

Port of ``repro/runtime/train_loop.py``.  Composes every substrate: config
-> model -> parameters and optimizer state placed over the mesh -> train
step -> synthetic data stream -> checkpoint manager (async, atomic,
retained) -> straggler monitor -> elastic re-mesh on injected failures.

One process drives every rank of a ``("data", "model")`` mesh
(launch/mesh.py), as the reference's single controller drives its
devices.  Two execution modes:
  * "pjit"          - the sharding policy's placement (models/sharding.py),
                      executed by models/parallel.py: each leaf cut into
                      its shards (tensor parallelism over the model axis,
                      expert parallelism, FSDP over data), the global batch
                      split over the data groups, and
                      ``steps.make_train_step(policy=)``: the loss is the
                      global token mean (the groups' token losses over the
                      global count, the MoE aux once), each shard's
                      gradient summed over the ranks that read it, and
                      AdamW on the distinct shards, every copy of a shard
                      bitwise equal to the others.
  * "dp_compressed" - the reference's shard_map path: parameters
                      replicated over the model axis (each distinct device
                      of a data row holds the row's replica), each row's
                      own step on its first replica, then the int8
                      error-feedback all-reduce of the gradients over the
                      rows (optim/compression.py), then the same AdamW
                      update on every replica; the loss is the rows' mean.

Checkpoints keep the reference's layout of whole stacked leaves: pjit mode
assembles each leaf from its shards, one at a time, on the first rank's
device and copies it into the host tree, and a restore cuts the whole
leaves into the current mesh's shards, which need not be the writer's.

Failure handling contract: a step raising FailureInjected triggers a
restore of the newest checkpoint; a failure that reports lost hosts first
shrinks the data axis (runtime/elastic.py).  Determinism: the data stream
is a pure function of the step, so a resumed run replays the same batches.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import tempfile
import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.synthetic import TokenStreamSpec, batch_at
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.models import steps as model_steps
from repro_torch.models.config import ModelConfig
from repro_torch.models.parallel import Placement, ShardedLM
from repro_torch.models.registry import build_model
from repro_torch.models.sharding import make_policy
from repro_torch.optim import adamw
from repro_torch.optim.compression import compress_tree_psum
from repro_torch.runtime import elastic, straggler
from repro_torch.tree import (lookup, named_leaves, reference_path,
                              scatter_tree, stacked_tree)


class FailureInjected(RuntimeError):
    def __init__(self, msg: str, lost_hosts: int = 0):
        super().__init__(msg)
        self.lost_hosts = lost_hosts


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 20
    ckpt_every: int = 5
    ckpt_dir: str = dataclasses.field(default_factory=_default_ckpt_dir)
    log_every: int = 5
    mode: str = "pjit"              # pjit | dp_compressed
    seed: int = 0
    straggler: straggler.StragglerConfig = dataclasses.field(
        default_factory=straggler.StragglerConfig)


class TrainLoop:
    """The loop over `mesh` (axes ("data", "model"); None means one card,
    which raises without one; ``make_mesh((d, m), ("data", "model"),
    devices=["cpu"] * (d * m))`` runs d x m ranks on the CPU).  pjit mode
    holds ``params`` (a ``parallel.ShardedLM``) and ``opt_state``;
    dp_compressed holds ``replicas`` and ``opt_states``, ``params`` and
    ``opt_state`` being the first's."""

    def __init__(self, cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                 loop_cfg: LoopConfig, mesh: Optional[Mesh] = None,
                 data_spec: Optional[TokenStreamSpec] = None,
                 failure_hook: Optional[Callable[[int], None]] = None):
        if loop_cfg.mode not in ("pjit", "dp_compressed"):
            raise ValueError(f"unknown mode {loop_cfg.mode!r}")
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.loop = loop_cfg
        self.mesh = mesh if mesh is not None else make_mesh(
            (1, 1), ("data", "model"), devices=["cuda"])
        self.data_spec = data_spec or TokenStreamSpec(
            vocab=cfg.vocab, seq_len=128, global_batch=8, seed=loop_cfg.seed)
        self.failure_hook = failure_hook
        self.manager = CheckpointManager(loop_cfg.ckpt_dir)
        self.timer = straggler.StepTimer()
        self.strag_state = straggler.StragglerState()
        self.metrics_log: list = []
        self._build()

    # -- construction --------------------------------------------------------

    def _build(self) -> None:
        self._place()
        self.names = [name for name, _ in
                      named_leaves(self.model.init_shapes())]
        if self.loop.mode == "pjit":
            self._init_placed()
            return
        gen = torch.Generator(device=self.devices[0])
        gen.manual_seed(self.loop.seed)
        first = self.model.init(gen, self.devices[0], trainable=True)
        self.replicas = [first] + [copy.deepcopy(first).to(dev)
                                   for dev in self.devices[1:]]
        self.opt_states = [adamw.init(self.opt_cfg, p)
                           for p in self.replicas]
        self.params, self.opt_state = first, self.opt_states[0]
        self.err_state = [[torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device)
                           for _, p in named_leaves(self.replicas[r])]
                          for r in self.row_firsts]

    def _init_placed(self) -> None:
        """pjit mode: the parameters drawn from the seed (the one-device
        draws) and cut over the mesh, zero moments, the step."""
        gen = torch.Generator(device=self.mesh.ranks[0])
        gen.manual_seed(self.loop.seed)
        self.params = self.model.init(gen, trainable=True, mesh=self.mesh)
        self.opt_state = adamw.init(self.opt_cfg, self.params)
        self.step_fn = model_steps.make_train_step(self.cfg, self.opt_cfg,
                                                   policy=self.policy)

    def _place(self) -> None:
        """The model, the policy, and in dp_compressed mode the replicas'
        devices (``devices``, ``row_of``, ``row_firsts``) of `self.mesh`."""
        cfg, mesh = self.cfg, self.mesh
        if tuple(mesh.axis_names) != ("data", "model"):
            raise ValueError(f"TrainLoop runs over a ('data', 'model') "
                             f"mesh, got axes {mesh.axis_names}")
        self.model = build_model(cfg)
        self.policy = make_policy(cfg, mesh)
        d = mesh.shape["data"]
        if self.loop.mode == "dp_compressed":
            # each distinct device of data row i holds row i's replica
            self.devices, self.row_of, self.row_firsts = [], [], []
            for i in range(d):
                self.row_firsts.append(len(self.devices))
                for dev in dict.fromkeys(mesh.devices[i]):
                    self.devices.append(dev)
                    self.row_of.append(i)
        rows = self.data_spec.global_batch
        per = d * (cfg.grad_accum if self.loop.mode == "pjit" else 1)
        if rows % per:
            raise ValueError(f"global batch {rows} does not split over {d} "
                             f"data ranks x {per // d} micro-batches")

    # -- steps ---------------------------------------------------------------

    def _rank_batch(self, batch: dict, i: int) -> dict:
        """Data row i's rows of the batch, on its first replica's device."""
        n = batch["labels"].shape[0] // len(self.row_firsts)
        return model_steps.as_batch({k: v[i * n:(i + 1) * n]
                                     for k, v in batch.items()},
                                    self.devices[self.row_firsts[i]])

    def _dp_step(self, batch: dict) -> dict:
        """Each row's own step, the compressed all-reduce over the rows,
        the same update on every replica."""
        metrics, grads = [], []
        for i, r in enumerate(self.row_firsts):
            m, g = model_steps.grads_of(self.cfg, self.replicas[r],
                                        self._rank_batch(batch, i))
            metrics.append(m)
            grads.append(g)
        avgs, self.err_state = compress_tree_psum(grads, self.err_state)
        om = None
        for r, params in enumerate(self.replicas):
            dev, g = self.devices[r], avgs[self.row_of[r]]
            if r != self.row_firsts[self.row_of[r]]:
                g = [x.to(dev, copy=True) for x in g]
            _, self.opt_states[r], m = adamw.update(
                self.opt_cfg, g, self.opt_states[r], params)
            om = om or m
        home = self.devices[0]
        loss = sum(m["loss"].to(home) for m in metrics) / len(metrics)
        return dict(metrics[0], **om, loss=loss)

    # -- checkpoint -----------------------------------------------------------

    def _tree(self) -> dict:
        """The parameters and optimizer state as the reference's tree
        {"params", "opt": {"m", "v", "step"}}, stacked, on the host: in
        pjit mode each leaf assembled from its shards on the first rank's
        device, one at a time, and copied once into its place on the
        host."""
        opt = self.opt_state
        if self.loop.mode == "pjit":
            sm = self.params
            home = sm.px.devices[0]

            def stack(per_copy):
                return stacked_tree(self.names, _Lazy(
                    lambda i: sm.whole(self.names[i], per_copy, home),
                    len(self.names)))
            params, m, v = (stack(sm.copies), stack(opt["m"]),
                            stack(opt["v"]))
        else:
            params = stacked_tree(self.names, [p for _, p in
                                               named_leaves(self.params)])
            m = stacked_tree(self.names, opt["m"])
            v = stacked_tree(self.names, opt["v"])
        return {"params": params, "opt": {"m": m, "v": v,
                                          "step": opt["step"].detach().cpu()}}

    def _save(self, step: int) -> None:
        # the tree is fresh host copies, which the loop never changes
        self.manager.save(step, self._tree(),
                          metadata={"step": step,
                                    "data_seed": self.data_spec.seed})

    def _restore(self) -> int:
        """The newest checkpoint written into the live state, in place: in
        pjit mode each whole leaf cut into this mesh's shards."""
        self.manager.wait()
        out = self.manager.restore_latest(self._tree_shapes())
        if out is None:
            return 0
        tree, meta, step = out
        if self.loop.mode == "pjit":
            sm, opt = self.params, self.opt_state
            for name in self.names:
                path, layer = reference_path(name)
                for src, per_copy in ((tree["params"], sm.copies),
                                      (tree["opt"]["m"], opt["m"]),
                                      (tree["opt"]["v"], opt["v"])):
                    whole = lookup(src, path)
                    sm.load(name, whole if layer is None else whole[layer],
                            per_copy)
            opt["step"] = tree["opt"]["step"].to(opt["step"].device)
            return step + 1
        for params, opt in zip(self.replicas, self.opt_states):
            scatter_tree(self.names, [p for _, p in named_leaves(params)],
                         tree["params"])
            scatter_tree(self.names, opt["m"], tree["opt"]["m"])
            scatter_tree(self.names, opt["v"], tree["opt"]["v"])
            opt["step"] = tree["opt"]["step"].to(opt["step"].device)
        return step + 1

    def _tree_shapes(self) -> dict:
        """The reference tree's leaves as meta tensors (shapes, dtypes)."""
        shapes = [p.shape for _, p in named_leaves(self.model.init_shapes())]

        def meta(dtype):
            return stacked_tree(self.names, [
                torch.empty(s, dtype=dtype, device="meta") for s in shapes],
                device="meta")
        moment = getattr(torch, self.opt_cfg.moment_dtype)
        return {"params": meta(torch.float32),
                "opt": {"m": meta(moment), "v": meta(moment),
                        "step": torch.empty((), dtype=torch.int32,
                                            device="meta")}}

    # -- main loop ------------------------------------------------------------

    def _sync(self) -> None:
        for dev in self.mesh.distinct_devices:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def run(self) -> Dict[str, float]:
        step = self._restore()
        while step < self.loop.total_steps:
            try:
                if self.failure_hook is not None:
                    self.failure_hook(step)
                t0 = time.perf_counter()
                batch = batch_at(self.data_spec, step)
                if self.loop.mode == "dp_compressed":
                    metrics = self._dp_step(batch)
                else:
                    self.params, self.opt_state, metrics = self.step_fn(
                        self.params, self.opt_state, **batch)
                self._sync()
                self.timer.record(time.perf_counter() - t0)
                self._monitor(step, metrics)
                if step % self.loop.ckpt_every == 0:
                    self._save(step)
                step += 1
            except FailureInjected as e:
                self._recover(e)
                step = self._restore()
        self.manager.wait()
        self.manager.close()
        return self.timer.summary()

    def _monitor(self, step: int, metrics) -> None:
        loss = float(metrics["loss"])
        self.metrics_log.append({"step": step, "loss": loss,
                                 "time_s": self.timer.last()})
        # one process: its own time is a one-host report
        self.strag_state, flagged = straggler.update(
            self.loop.straggler, self.strag_state, [self.timer.last()])
        if flagged:
            self.metrics_log[-1]["stragglers"] = flagged

    def _recover(self, e: FailureInjected) -> None:
        """Failure path: optionally shrink the data axis (the mesh's first
        devices survive, and with them their ranks' state).  The reference
        draws a fresh model here, which its restore then replaces; the
        port keeps the survivors' state where its shards keep their
        shapes, and ``_restore`` writes the newest checkpoint over it in
        place, so a recovery holds no second copy of the parameters and
        moments.  Under FSDP the data shards grow as the data axis
        shrinks: the old shards are dropped and the leaves placed anew on
        the survivors, for ``_restore`` to fill.  (Step 0 always saves, so
        a restore finds a checkpoint once any step has run.)
        dp_compressed's error feedback restarts at zero, as the
        reference's rebuild restarts it."""
        if e.lost_hosts > 0 and self.loop.mode == "pjit":
            plan = elastic.shrink_data_axis(self.mesh, e.lost_hosts)
            self.mesh = elastic.build_mesh(plan, devices=self.mesh.ranks)
            old = self.params
            self._place()
            if any(dp is not None for _, dp in old.px.splits.values()):
                del old
                self.params = self.opt_state = None
                self._init_placed()
                return
            kept = ShardedLM(Placement(self.cfg, self.policy),
                             old.ranks[:self.mesh.size])
            slot = {id(c): i for i, c in enumerate(old.copies)}
            opt = self.opt_state
            self.params, self.opt_state = kept, {
                k: [opt[k][slot[id(c)]] for c in kept.copies]
                for k in ("m", "v")}
            self.opt_state["step"] = opt["step"]
            self.step_fn = model_steps.make_train_step(
                self.cfg, self.opt_cfg, policy=self.policy)
        if self.loop.mode == "dp_compressed":
            for errs in self.err_state:
                for err in errs:
                    err.zero_()


class _Lazy:
    """A sequence whose item i is made by `fn(i)` when it is read."""

    def __init__(self, fn, n: int):
        self.fn, self.n = fn, n

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int):
        return self.fn(i)


__all__ = ["TrainLoop", "LoopConfig", "FailureInjected"]
