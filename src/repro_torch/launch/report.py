"""Tables of the dry-run and roofline JSON records.

Counterpart of ``repro/launch/report.py``, reading the port's records
(experiments/torch/dryrun/ and experiments/torch/roofline/, written by
``launch.dryrun`` and ``launch.roofline``).  The records keep the
reference's keys, so the tables have the reference's columns and read
either package's records; the port's "compile s" column holds the meta
run's seconds, its "HLO flops" the dry run's count.

    PYTHONPATH=src python -m repro_torch.launch.report > dryrun_tables.md
"""

from __future__ import annotations

import glob
import json
import os
from typing import List

HERE = os.path.dirname(__file__)
DRYRUN_DIR = os.path.join(HERE, "..", "..", "..", "experiments", "torch",
                          "dryrun")
ROOF_DIR = os.path.join(HERE, "..", "..", "..", "experiments", "torch",
                        "roofline")

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k",
               "allpairs"]


def _load(directory: str) -> List[dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def _gib(x) -> str:
    return f"{x / 2**30:.2f}"


def _fmt_e(x) -> str:
    return f"{x:.2e}"


def dryrun_table() -> str:
    recs = _load(DRYRUN_DIR)
    recs.sort(key=lambda r: (r["arch"], SHAPE_ORDER.index(r["shape"]),
                             r["mesh"]))
    lines = [
        "| arch | shape | mesh | compile s | args GiB/dev | temp GiB/dev |"
        " HLO flops (scan) | coll GiB/dev | coll ops |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        mem = r.get("memory", {})
        cost = r.get("cost", {})
        coll = r.get("collectives", {})
        mesh = "2x16x16" if "pod" in r["mesh"] else "16x16"
        lines.append(
            f"| {r['arch']} | {r['shape']} | {mesh} | {r['compile_s']} | "
            f"{_gib(mem.get('argument_size_in_bytes', 0))} | "
            f"{_gib(mem.get('temp_size_in_bytes', 0))} | "
            f"{_fmt_e(cost.get('flops', 0))} | "
            f"{_gib(coll.get('total_bytes', 0))} | "
            f"{sum(coll.get('count_by_kind', {}).values())} |")
    return "\n".join(lines)


def roofline_table() -> str:
    recs = _load(ROOF_DIR)
    recs.sort(key=lambda r: (r["arch"], SHAPE_ORDER.index(r["shape"])))
    lines = [
        "| arch | shape | method | compute s | memory s | collective s |"
        " bottleneck | MODEL_FLOPS (global) | model/HLO flops | useful frac |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if "__" in r["label"].split("pod1")[-1]:
            continue  # skip tagged (hillclimb variant) records
        # tiny cells can extrapolate to epsilon-negative values; clamp
        t = {k: max(v, 0.0) for k, v in r["terms_s"].items()}
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['method']} | "
            f"{t['compute_s']:.3f} | {t['memory_s']:.3f} | "
            f"{t['collective_s']:.3f} | "
            f"{r['bottleneck'].replace('_s', '')} | "
            f"{_fmt_e(r['model_flops_global'])} | "
            f"{r['model_vs_hlo_flops']:.3f} | "
            f"{r['useful_fraction']:.2%} |")
    return "\n".join(lines)


def collective_breakdown(label_filter: str = "") -> str:
    recs = [r for r in _load(ROOF_DIR) if label_filter in r["label"]]
    lines = ["| cell | all-gather | all-reduce | reduce-scatter |"
             " all-to-all | permute |", "|---|---|---|---|---|---|"]
    for r in recs:
        k = r.get("coll_by_kind", {})
        lines.append(
            f"| {r['arch']}/{r['shape']} | "
            f"{_gib(k.get('all-gather', 0))} | "
            f"{_gib(k.get('all-reduce', 0))} | "
            f"{_gib(k.get('reduce-scatter', 0))} | "
            f"{_gib(k.get('all-to-all', 0))} | "
            f"{_gib(k.get('collective-permute', 0))} |")
    return "\n".join(lines)


def main() -> None:
    print("## Dry-run (generated)\n")
    print(dryrun_table())
    print("\n## Roofline (generated)\n")
    print(roofline_table())
    print("\n### Collective breakdown (GiB/device)\n")
    print(collective_breakdown())


if __name__ == "__main__":
    main()
