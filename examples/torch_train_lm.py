"""End-to-end LM training with the PyTorch port, on the fault-tolerant
runtime (runtime/train_loop.TrainLoop: checkpoints, straggler monitor,
deterministic resume).

    PYTHONPATH=src python examples/torch_train_lm.py --preset tiny \\
        --steps 200 [--device cpu]
    PYTHONPATH=src python examples/torch_train_lm.py --arch llama3.2-3b

The counterpart of examples/train_lm.py for ``repro_torch``, with its
presets:
  tiny  - ~1M params, a few hundred steps in minutes on a CPU;
  100m  - ~100M-param dense LM, for a card.
Any arch id is also accepted via --arch (its full config).  ``--device``
defaults to ``cuda`` (it raises without a card); ``--device cpu`` trains on
the CPU; ``--data-axis N`` with ``--device cpu`` runs N data ranks there.
"""

import argparse
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.data.synthetic import TokenStreamSpec
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.runtime.train_loop import LoopConfig, TrainLoop

PRESETS = {
    "tiny": ModelConfig(
        arch="tiny-lm", n_layers=4, d_model=128, n_heads=4, n_kv_heads=2,
        d_ff=512, vocab=2048, dtype="float32", logits_chunk=0),
    "100m": ModelConfig(
        arch="lm-100m", n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
        d_ff=3072, vocab=32768, logits_chunk=512),
}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=sorted(PRESETS))
    ap.add_argument("--arch", default=None,
                    help="arch id (overrides preset)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--data-axis", type=int, default=1,
                    help="data ranks on the device")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = get_config(args.arch) if args.arch else PRESETS[args.preset]
    mesh = make_mesh((args.data_axis, 1), ("data", "model"),
                     devices=[args.device] * args.data_axis)

    loop = TrainLoop(
        cfg,
        adamw.AdamWConfig(peak_lr=3e-4, warmup_steps=20,
                          total_steps=args.steps),
        LoopConfig(total_steps=args.steps, ckpt_every=50,
                   ckpt_dir=args.ckpt_dir, log_every=20),
        mesh,
        data_spec=TokenStreamSpec(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch),
    )
    summary = loop.run()
    first = loop.metrics_log[0]["loss"]
    last = loop.metrics_log[-1]["loss"]
    print(f"steps={args.steps} loss {first:.3f} -> {last:.3f}  "
          f"step_time p50={summary.get('p50_s', 0):.3f}s")
    assert last < first, "training should reduce loss"
    print("OK")


if __name__ == "__main__":
    main()
