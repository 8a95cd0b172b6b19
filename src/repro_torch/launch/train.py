"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
        [--smoke] [--steps 100] [--global-batch 8] [--seq 256] \\
        [--device cpu | --devices cuda:0,cuda:1] [--model-axis 16] \\
        [--mode dp_compressed]

Port of ``repro/launch/train.py``.  It runs the fault-tolerant
``TrainLoop`` (runtime/train_loop.py) on ``cuda`` (one card), or over the
devices of ``--devices`` (a comma-separated list; names may repeat, as
"cpu,cpu,cpu,cpu" for four ranks on the CPU), and raises without a card
unless the CPU is asked for.  The mesh is ``pick_mesh_shape``'s (data,
model) layout: a model axis of ``--model-axis`` (the reference's default
of 16), halved until it divides the devices, over which the sharding
policy places the parameters (models/parallel.py); the rest is data.
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import get_config, list_archs
from repro_torch.data.synthetic import TokenStreamSpec
from repro_torch.launch.mesh import make_mesh
from repro_torch.optim import adamw
from repro_torch.runtime.train_loop import LoopConfig, TrainLoop


def pick_mesh_shape(n_dev: int, model_axis: int = 16):
    while model_axis > 1 and (n_dev % model_axis or n_dev < model_axis):
        model_axis //= 2
    return (n_dev // model_axis, model_axis)


def main(argv=None) -> TrainLoop:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpts"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--mode", default="pjit",
                    choices=("pjit", "dp_compressed"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: one data rank")
    ap.add_argument("--devices", default=None,
                    help="comma-separated devices of the mesh, e.g. "
                         "cuda:0,cuda:1 or cpu,cpu (overrides --device)")
    ap.add_argument("--model-axis", type=int, default=16,
                    help="the model axis's size, halved until it divides "
                         "the devices (the rest is data)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    devices = (args.devices.split(",") if args.devices else [args.device])
    shape = pick_mesh_shape(len(devices), model_axis=args.model_axis)
    mesh = make_mesh(shape, ("data", "model"), devices=devices)
    print(f"devices={len(devices)} mesh={shape} arch={cfg.arch}")

    loop = TrainLoop(
        cfg,
        adamw.AdamWConfig(peak_lr=args.lr,
                          warmup_steps=max(args.steps // 20, 5),
                          total_steps=args.steps,
                          moment_dtype=cfg.opt_state_dtype),
        LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                   ckpt_dir=args.ckpt_dir, mode=args.mode),
        mesh,
        data_spec=TokenStreamSpec(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.global_batch),
    )
    summary = loop.run()
    losses = [m["loss"] for m in loop.metrics_log]
    print(f"done: loss {losses[0]:.3f} -> {losses[-1]:.3f}; {summary}")
    return loop


if __name__ == "__main__":
    main()
