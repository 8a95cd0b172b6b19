#!/usr/bin/env python3
"""What the top-k merge kernel's design choices are worth, on one NVIDIA GPU.

    python3 scripts/merge_ablation.py          # from the repository root

Builds src/repro_torch/kernels/csrc/pcc_topk.cu as it is and in variants
that each undo or change one choice (text replaced in a copy of the
source, built beside the package's own libraries under
kernels/_build/ablation/), then times the merge kernel of every build on
the same select scratch, in the order A B .. B A, with CUDA events:
Table II's one pass (n = 17,555, l = 5,072, 2,415 tiles; kk = 10 and 1)
and the 1,639 x 17,555 grid pass (kk = 10), as in chip_smoke.py.  Every
variant computes the same state, and each is held bitwise against
topk_merge_plain before it is timed:

    no-prune  walk every list whose head beats the (empty) state on a
              row's first step, not only those among the step's kk best
    walk-2    a passing lane loads its list's first 2 entries (not 4)
    walk-8    ... its first 8 entries
    4-warps   CTAs of 4 warps (rows), not 8

Prints the card's name and power limit, then one line per case: each
build's median ms over its runs.
"""

from __future__ import annotations

import statistics
import sys

from ablation_common import ROOT, build, card, event_ms, run_with

N_SEEK, L_SEEK, N_TF = 17_555, 5_072, 1_639   # chip_smoke.py's shapes
RUNS = 7
VARIANTS = {
    "as is": [],
    "no-prune": [("    if (held == 0 && kk <= 32) {   // uniform\n",
                  "    if (false) {\n")],
    "walk-2": [("constexpr int WALK = 4;", "constexpr int WALK = 2;")],
    "walk-8": [("constexpr int WALK = 4;", "constexpr int WALK = 8;")],
    "4-warps": [("constexpr int MERGE_WARPS = 8;",
                 "constexpr int MERGE_WARPS = 4;")],
}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("merge_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.plan import ExecutionPlan
    from repro_torch.data.expression import ExpressionSpec, artificial
    from repro_torch.kernels.pcc_tile import (topk_merge, topk_merge_plain,
                                              topk_select)

    torch.backends.cuda.matmul.allow_tf32 = False
    print(card())
    mods = build("pcc_topk", "pcc_topk", VARIANTS)

    x = torch.from_numpy(artificial(ExpressionSpec(
        n=N_SEEK, l=L_SEEK, seed=0))).cuda()
    plan = ExecutionPlan.create(N_SEEK, L_SEEK)
    u = plan.prepare(x)
    total = plan.total_tiles
    x_tf = torch.from_numpy(artificial(ExpressionSpec(
        n=N_TF, l=L_SEEK, seed=1))).cuda()
    rplan = ExecutionPlan.create(N_TF, L_SEEK, n_cols=N_SEEK)
    u_tf, v_sk = rplan.prepare_pair(x_tf, x)
    gc = rplan.workload.grid_cols
    cases = []
    for kk in (10, 1):
        cases.append((f"Table II one pass, kk={kk}", u, total, dict(
            t=plan.t, l_blk=plan.l_blk, kk=kk, n_cols_valid=N_SEEK,
            symmetric_problem=True, epilogue=plan.epilogue_spec),
            dict(m=plan.m, t=plan.t, kk=kk)))
    cases.append(("grid one pass, kk=10", u_tf, rplan.total_tiles, dict(
        t=rplan.t, l_blk=rplan.l_blk, kk=10, n_cols_valid=N_SEEK,
        symmetric_problem=False, epilogue=rplan.epilogue_spec, v_pad=v_sk,
        grid_cols=gc), dict(m=rplan.m, t=rplan.t, kk=10, grid_cols=gc)))
    order = list(mods) + list(reversed(mods))
    for label, op, n_tiles, skw, mkw in cases:
        scratch = topk_select(op, 0, n_tiles, pass_tiles=n_tiles, **skw)
        want = topk_merge_plain(scratch, 0, n_tiles, pass_tiles=n_tiles,
                                **mkw)

        def run():
            return topk_merge(scratch, 0, n_tiles, pass_tiles=n_tiles, **mkw)
        for name in mods:
            got = run_with(mods[name], run)
            torch.cuda.synchronize()
            if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in zip(got, want)):
                raise AssertionError(f"{label} [{name}]: the merge's state "
                                     f"is not topk_merge_plain's bits")
        times = {name: [] for name in mods}
        for _ in range(RUNS):
            for name in order:
                times[name].append(run_with(mods[name], lambda: event_ms(
                    run, 1, warm=False)))
        print(f"{label}: " + "; ".join(
            f"{name} {statistics.median(ts):.4f} ms"
            for name, ts in times.items()) + " (each bitwise plain)")
        del scratch, want
    return 0


if __name__ == "__main__":
    sys.exit(main())
