"""Hill-climbing: named experiments = (cell, config transform).

Counterpart of ``repro/launch/hillclimb.py``, with the same experiments.
Each re-runs the roofline analysis count (``launch/roofline.py``: the dry
run on the meta device) with one change and a tag, so a before / after
comparison can cite terms from JSON records
(experiments/torch/roofline/<arch>__<shape>__pod1__<tag>.json).  The
port executes ``moe_impl="per_example"``, ``attn_impl="causal_sliced"``
and ``param_sharding="fsdp_tp"``; no code of either package reads
``param_dtype`` (parameters are float32), and the analysis variant sets
``grad_accum`` to 1 already, so the nemotron experiments count as their
base cell does.

    python -m repro_torch.launch.hillclimb --exp qwen3-pe
    python -m repro_torch.launch.hillclimb --list
"""

import argparse
import dataclasses

from repro_torch.launch.roofline import analyze_cell

# name -> (arch, shape, tag, transform)
EXPERIMENTS = {}


def _exp(name, arch, shape, tag, **cfg_changes):
    def tf(cfg):
        return dataclasses.replace(cfg, **cfg_changes)
    EXPERIMENTS[name] = (arch, shape, tag, tf)


# --- cell 1: qwen3-moe train_4k: global-sort routing scatters into a
#     dispatch buffer replicated over the mesh ----------------------------
_exp("qwen3-pe", "qwen3-moe-30b-a3b", "train_4k", "pe",
     moe_impl="per_example")
_exp("qwen3-pe-prefill", "qwen3-moe-30b-a3b", "prefill_32k", "pe",
     moe_impl="per_example")

# --- cell 2: nemotron-4-340b train_4k: FSDP parameter all-gathers in f32,
#     repeated across forward, recompute and backward ----------------------
_exp("nemotron-bf16-params", "nemotron-4-340b", "train_4k", "bf16p",
     param_dtype="bfloat16")
_exp("nemotron-bf16-noaccum", "nemotron-4-340b", "train_4k", "bf16p-ga1",
     param_dtype="bfloat16", grad_accum=1)

# --- cell 3: llama3.2-3b prefill_32k (paper-representative: causal
#     attention = triangular job matrix; C1 realised as prefix slicing) ----
_exp("llama-causal-sliced", "llama3.2-3b", "prefill_32k", "cs",
     attn_impl="causal_sliced")
_exp("llama-train-causal-sliced", "llama3.2-3b", "train_4k", "cs",
     attn_impl="causal_sliced")
# sharding alternative for the 3B-dense cell: FSDP instead of 16-way TP
_exp("llama-train-fsdp", "llama3.2-3b", "train_4k", "fsdp",
     param_sharding="fsdp_tp")


def run_experiment(name: str) -> dict:
    arch, shape, tag, tf = EXPERIMENTS[name]
    return analyze_cell(arch, shape, cfg_extra=tf, tag=tag)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--exp", action="append", default=[])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args()
    if args.list:
        for k, (a, s, t, _) in EXPERIMENTS.items():
            print(f"{k}: {a} x {s} [{t}]")
        return
    names = list(EXPERIMENTS) if args.all else args.exp
    for n in names:
        run_experiment(n)


if __name__ == "__main__":
    main()
