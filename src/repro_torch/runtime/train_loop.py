"""Fault-tolerant training loop.

Port of ``repro/runtime/train_loop.py``.  Composes every substrate: config
-> model -> parameters and optimizer state on each data rank -> train
step -> synthetic data stream -> checkpoint manager (async, atomic,
retained) -> straggler monitor -> elastic re-mesh on injected failures.

One process drives every rank of a ``("data", "model")`` mesh
(launch/mesh.py), as the reference's single controller drives its
devices.  Two execution modes:
  * "pjit"          - the sharding policy's placement (models/sharding.py).
                      Each leaf's spec is computed; one that names an axis
                      of size > 1 (tensor parallelism, FSDP) raises
                      NotImplementedError, since executing it is ROADMAP A
                      part 5.  So the data axis runs: every data rank holds
                      a replica, runs its rows of the global batch, and the
                      loss is the global token mean (the sum of the ranks'
                      token losses over the global count); the ranks'
                      gradients are summed in rank order, every replica
                      applies the same AdamW update and stays bitwise equal
                      to the others.  An MoE config at data size > 1 raises:
                      its capacity and aux loss span the global batch, so a
                      split by rank would compute something else.
  * "dp_compressed" - the reference's shard_map path: each rank's own step,
                      then the int8 error-feedback all-reduce of the
                      gradients (optim/compression.py), then the same AdamW
                      update on every rank; the loss is the ranks' mean.

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
from repro_torch.models.registry import build_model
from repro_torch.models.sharding import axes_of, make_policy
from repro_torch.optim import adamw
from repro_torch.optim.compression import compress_tree_psum
from repro_torch.runtime import elastic, straggler
from repro_torch.tree import named_leaves, scatter_tree, stacked_tree

PART5 = ("training over a sharded placement (tensor parallelism or FSDP "
         "over explicit devices) is the training half of ROADMAP A part 5; "
         "serving executes such a placement (models/parallel.py)")


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
    which raises without one; ``make_mesh((d, 1), ("data", "model"),
    devices=["cpu"] * d)`` runs d data ranks on the CPU)."""

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
        gen = torch.Generator(device=self.devices[0])
        gen.manual_seed(self.loop.seed)
        first = self.model.init(gen, self.devices[0], trainable=True)
        self.replicas = [first] + [copy.deepcopy(first).to(dev)
                                   for dev in self.devices[1:]]
        self.opt_states = [adamw.init(self.opt_cfg, p)
                           for p in self.replicas]
        self.names = [name for name, _ in named_leaves(first)]
        if self.loop.mode == "dp_compressed":
            self.err_state = [[torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device)
                               for _, p in named_leaves(r)]
                              for r in self.replicas]

    def _place(self) -> None:
        """The model, the policy and the data ranks of `self.mesh`; raises
        where this slice cannot run the policy's placement."""
        cfg, mesh = self.cfg, self.mesh
        if tuple(mesh.axis_names) != ("data", "model"):
            raise ValueError(f"TrainLoop runs over a ('data', 'model') "
                             f"mesh, got axes {mesh.axis_names}")
        self.model = build_model(cfg)
        self.policy = make_policy(cfg, mesh)
        sizes = mesh.shape
        if self.loop.mode == "pjit":
            specs = self.policy.params_specs(cfg, self.model.init_shapes())
            for path, spec in specs.items():
                wide = [a for a in axes_of(spec) if sizes[a] > 1]
                if wide:
                    raise NotImplementedError(
                        f"{cfg.arch}: {path} is placed by spec {spec} over "
                        f"{wide} of mesh {dict(sizes)}; {PART5}")
            if cfg.uses_moe and sizes["data"] > 1:
                raise NotImplementedError(
                    f"{cfg.arch}: MoE in pjit mode at data size "
                    f"{sizes['data']}: its capacity and aux loss span the "
                    f"global batch, which no rank holds; use data size 1 "
                    f"or mode 'dp_compressed'")
        elif sizes["model"] > 1:
            raise NotImplementedError(
                f"dp_compressed over a model axis of size {sizes['model']}: "
                f"{PART5}")
        # the data ranks: one replica each
        self.devices = [mesh.devices[i, 0] for i in range(sizes["data"])]
        d = len(self.devices)
        rows = self.data_spec.global_batch
        per = d * (cfg.grad_accum if self.loop.mode == "pjit" else 1)
        if rows % per:
            raise ValueError(f"global batch {rows} does not split over {d} "
                             f"data ranks x {per // d} micro-batches")

    @property
    def params(self):
        """Data rank 0's parameters (every replica holds the same bits)."""
        return self.replicas[0]

    @property
    def opt_state(self):
        return self.opt_states[0]

    # -- steps ---------------------------------------------------------------

    def _rank_batch(self, batch: dict, r: int) -> dict:
        n = batch["labels"].shape[0] // len(self.devices)
        return model_steps.as_batch({k: v[r * n:(r + 1) * n]
                                     for k, v in batch.items()},
                                    self.devices[r])

    def _update_all(self, grads_by_rank) -> dict:
        """The same AdamW update on every replica; rank 0's metrics."""
        out = None
        for r, params in enumerate(self.replicas):
            _, self.opt_states[r], om = adamw.update(
                self.opt_cfg, grads_by_rank[r], self.opt_states[r], params)
            out = om if out is None else out
        return out

    def _pjit_step(self, batch: dict) -> dict:
        """One step over the global batch: micro-batches as the reference's
        scan runs them, each split over the data ranks."""
        metrics, grads = model_steps.accumulated_grads(
            self.cfg, batch, self._ranks_grads)
        om = self._update_all([grads] + [[g.to(dev, copy=True) for g in grads]
                                         for dev in self.devices[1:]])
        return dict(metrics, **om)

    def _ranks_grads(self, mb: dict):
        """(metrics, gradients on rank 0's device) of one (micro-)batch over
        the data ranks: each rank's token losses over the batch's global
        count, summed in rank order."""
        d, home = len(self.devices), self.devices[0]
        # one rank divides by its own count, as the one-device step does
        count = None if d == 1 else max(float((mb["labels"] >= 0).sum()), 1.0)
        grads = metrics = None
        for r in range(d):
            m, g = model_steps.grads_of(self.cfg, self.replicas[r],
                                        self._rank_batch(mb, r), count=count)
            m = {k: v.to(home) for k, v in m.items()}
            g = [x.to(home) for x in g]
            if grads is None:
                metrics, grads = m, g
            else:
                grads = [a + b for a, b in zip(grads, g)]
                # the MoE aux (refused at d > 1) is 0: losses and xents add
                metrics = {"loss": metrics["loss"] + m["loss"],
                           "xent": metrics["xent"] + m["xent"],
                           "aux": m["aux"]}
        return metrics, grads

    def _dp_step(self, batch: dict) -> dict:
        """Each rank's own step, the compressed all-reduce, the update."""
        metrics, grads = [], []
        for r, params in enumerate(self.replicas):
            m, g = model_steps.grads_of(self.cfg, params,
                                        self._rank_batch(batch, r))
            metrics.append(m)
            grads.append(g)
        avgs, self.err_state = compress_tree_psum(grads, self.err_state)
        om = self._update_all(avgs)
        home = self.devices[0]
        loss = sum(m["loss"].to(home) for m in metrics) / len(metrics)
        return dict(metrics[0], **om, loss=loss)

    # -- checkpoint -----------------------------------------------------------

    def _tree(self) -> dict:
        """Rank 0's parameters and optimizer state as the reference's tree
        {"params", "opt": {"m", "v", "step"}}, stacked, on the host."""
        params = [p for _, p in named_leaves(self.params)]
        opt = self.opt_state
        return {"params": stacked_tree(self.names, params),
                "opt": {"m": stacked_tree(self.names, opt["m"]),
                        "v": stacked_tree(self.names, opt["v"]),
                        "step": opt["step"].detach().cpu()}}

    def _save(self, step: int) -> None:
        # the tree is fresh host copies, which the loop never changes
        self.manager.save(step, self._tree(),
                          metadata={"step": step,
                                    "data_seed": self.data_spec.seed})

    def _restore(self) -> int:
        self.manager.wait()
        like = self._tree_shapes()
        out = self.manager.restore_latest(like)
        if out is None:
            return 0
        tree, meta, step = out
        for params, opt in zip(self.replicas, self.opt_states):
            scatter_tree(self.names, [p for _, p in named_leaves(params)],
                         tree["params"])
            scatter_tree(self.names, opt["m"], tree["opt"]["m"])
            scatter_tree(self.names, opt["v"], tree["opt"]["v"])
            opt["step"] = tree["opt"]["step"].to(opt["step"].device)
        return step + 1

    def _tree_shapes(self) -> dict:
        """The reference tree's leaves as meta tensors (shapes, dtypes)."""
        def meta(ts):
            return stacked_tree(self.names, [t.to("meta") for t in ts],
                                device="meta")
        opt = self.opt_state
        return {"params": meta([p for _, p in named_leaves(self.params)]),
                "opt": {"m": meta(opt["m"]), "v": meta(opt["v"]),
                        "step": opt["step"].to("meta")}}

    # -- main loop ------------------------------------------------------------

    def _sync(self) -> None:
        for dev in dict.fromkeys(self.devices):
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
                    metrics = self._pjit_step(batch)
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
        devices survive, and with them their replicas).  The reference
        draws a fresh model here, which its restore then replaces; the
        port keeps the surviving replicas, and ``_restore`` writes the
        newest checkpoint over their leaves in place, so a recovery holds
        no second copy of the parameters and moments.  (Step 0 always
        saves, so a restore finds a checkpoint once any step has run.)
        dp_compressed's error feedback restarts at zero, as the
        reference's rebuild restarts it."""
        if e.lost_hosts > 0 and self.loop.mode == "pjit":
            plan = elastic.shrink_data_axis(self.mesh, e.lost_hosts)
            self.mesh = elastic.build_mesh(plan, devices=self.mesh.ranks)
            self._place()
            del self.replicas[len(self.devices):]
            del self.opt_states[len(self.devices):]
        if self.loop.mode == "dp_compressed":
            for errs in self.err_state:
                for err in errs:
                    err.zero_()


__all__ = ["TrainLoop", "LoopConfig", "FailureInjected"]
