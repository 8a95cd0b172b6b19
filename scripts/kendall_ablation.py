#!/usr/bin/env python3
"""Where the merge-sort Kendall kernel's time goes, and how it compares with
another tree's, on one NVIDIA GPU.

    python3 scripts/kendall_ablation.py [--parent OTHER/src]
                                        # from the repository root

Builds src/repro_torch/kernels/csrc/kendall_merge.cu as it is and in
variants that each leave one part of the work out (ablation_common.py),
then times every build on the TF triangle of chip_smoke.py (1,639 rows at
l = 5,072, 28 tiles in one launch: normal rows in tau-a, uint16 keys and
one sort a pair; floor(8 u) rows in tau-b, uint32 keys and two sorts), in
the order A B .. B A, with CUDA events.  A left-out variant's outputs are
wrong by design; the kernel as it is and the alternatives below are held
against this tree's plain version on one tile (bitwise).  The difference
between the kernel's time and a variant's is what the left-out part
costs there:

    no-gather   the keys' gather from the staged codes in row order
                (keys made from the position instead; the codes are still
                staged)
    no-leaf     the register leaf sort and its swap count
    no-search   the co-rank binary searches of the merge levels (each
                thread starts at the midpoint)
    no-store    the merge levels' stores (the loads and compares stay)
    warp-only   the merge levels that wait on the CTA (the first five,
                within a warp, stay)

and an alternative, right but built otherwise:

    four-ctas   a register budget for four CTAs an SM at P = 256 (64
                registers), the code buffers cut to what lets four fit

With --parent, the kernel of the tree whose package is under OTHER/src
(its kernels/kendall_merge.py, built by its own kernels/_build.py into its
own tree) and this tree's, in turns (parent, change, change, parent),
median of 3 each: the two cases above, then the TF rows cut to l = 96,
256, 512 and 1,024 in tau-a; the two agree bitwise.  For each, the device
memory of each tree's first call from a fresh operand: its peak and what
it keeps (the rank structures, cached beside the operand) above what was
held before, the output excluded.

Prints the card's name and power limit, then one line per case and
build: ms (both runs), and for TF tau-a the share of the phase-23.5
bound; then the --parent lines.
"""

from __future__ import annotations

import statistics
import sys
from pathlib import Path

from ablation_common import ROOT, build, card, event_ms, load_path, run_with

N_TF, L = 1_639, 5_072       # chip_smoke.py N_TF, L_SEEK
# phase 23.5's compare bound at the TF triangle (tau-a) at a 1,980 MHz SM
# clock: each pair of distinct non-constant rows once
BOUND_MS = 5.010
VARIANTS = {
    "as is": [],
    "no-gather": [("      v[e] = k < l ? code_s[ord_s[k]] : SENT16;\n",
                   "      v[e] = k < l ? (uint32_t)(k * 7919 % l) : SENT16;\n"),
                  ("    v[e] = k < l ? ((uint32_t)run_s[k] << 16) | "
                   "code_s[ord_s[k]] : SENT32;\n",
                   "    v[e] = k < l ? ((uint32_t)run_s[k] << 16) | "
                   "(uint32_t)(k * 7919 % l) : SENT32;\n")],
    "no-leaf": [("  unsigned inv = leaf_sort<E>(v);\n",
                 "  unsigned inv = 0;\n")],
    "no-search": [("  int lo = max(0, d - blk), n = min(d, blk) - lo;\n",
                   "  int lo = (max(0, d - blk) + min(d, blk)) >> 1, n = 0;\n")],
    "no-store": [("      if (STORE) out[s] = (K)min(a, b);\n",
                  "      if (STORE && tl && !tl) out[s] = (K)a;\n"),
                 ("      if (STORE) dst[at<K, E>(p + d + s)] = (K)min(a, b);\n",
                  "      if (STORE && tl && !tl) dst[at<K, E>(p + d + s)] = "
                  "(K)a;\n")],
    "warp-only": [("  for (int k = 0; k < LEVELS - 1; ++k) {\n",
                   "  for (int k = 0; k < (LEVELS < 5 ? LEVELS : 5) - 1; "
                   "++k) {\n"),
                  ("    inv += merge_level<K, E, true>(src, dst, LEVELS - 1, "
                   "g);\n",
                   "    inv += merge_level<K, E, true>(src, dst, "
                   "(LEVELS < 5 ? LEVELS : 5) - 1, g);\n"),
                  ("    inv += merge_level<K, E, false>(src, dst, LEVELS - 1, "
                   "g);\n",
                   "    inv += merge_level<K, E, false>(src, dst, "
                   "(LEVELS < 5 ? LEVELS : 5) - 1, g);\n")],
    "four-ctas": [("  return p * groups >= 512 ? (e <= 16 ? 2 : 1) : "
                   "(e >= 32 ? 2 : 3);\n",
                   "  return p * groups >= 512 ? (e <= 16 ? 2 : 1) : "
                   "(e >= 32 ? 2 : p == 256 ? 4 : 3);\n")],
}
# the builds that are right, held bitwise against the plain version
ALTERNATIVES = ("as is", "four-ctas")


def cases(x_tf, x_ties, ls=()):
    """(label, operand, launch keywords): the TF triangle in tau-a, the
    floor(8 u) rows in tau-b, each in one launch of every tile, then the TF
    rows cut to each l of `ls` in tau-a."""
    import torch
    from repro_torch.core.plan import ExecutionPlan
    from repro_torch.kernels.pcc_tile import EpilogueSpec
    out = []
    for label, x, lk, tau_b in (
            (f"TF tau-a, l={L}", x_tf, L, False),
            (f"floor(8 u) tau-b, l={L}", x_ties, L, True),
            *((f"TF tau-a, l={lk}", x_tf[:, :lk].contiguous(), lk, False)
              for lk in ls)):
        plan = ExecutionPlan.create(N_TF, lk, measure="kendall")
        kw = dict(t=plan.t, pass_tiles=plan.total_tiles, l=lk, tau_b=tau_b,
                  epilogue=EpilogueSpec(clip=(-1.0, 1.0)) if tau_b
                  else plan.epilogue_spec)
        out.append((label, plan.prepare(x), kw))
    torch.cuda.synchronize()
    return out


def ablation(x_tf, x_ties):
    """Every variant of this tree's kernel in turns on the two cases."""
    import torch
    from repro_torch.kernels import kendall_merge as km
    mods = build("kendall_merge", "kendall_merge", VARIANTS)
    order = list(mods) + list(reversed(mods))
    for label, u, kw in cases(x_tf, x_ties):
        want = km.kendall_merge_tiles_plain(u, 0, **{**kw, "pass_tiles": 1})
        for name in ALTERNATIVES:
            got = run_with(mods[name], lambda: km.kendall_merge_tiles(
                u, 0, **{**kw, "pass_tiles": 1}))
            if not torch.equal(got, want):
                raise AssertionError(f"{label} [{name}]: kernel differs "
                                     f"from plain")
        times = {name: [] for name in mods}
        for name in order:
            times[name].append(run_with(mods[name], lambda: event_ms(
                lambda: km.kendall_merge_tiles(u, 0, **kw), 3)))
        for name, ts in times.items():
            share = (f", {100 * BOUND_MS / statistics.mean(ts):.2f} % of "
                     f"the {BOUND_MS} ms bound" if "tau-a" in label else "")
            print(f"{label} [{name}]: {ts[0]:.3f} / {ts[1]:.3f} ms{share}")


def against_parent(parent_src: Path, x_tf, x_ties, where: str):
    """The kernel of the tree under parent_src and this tree's in turns,
    bitwise equal, with each one's memory on a fresh operand."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.kendall_merge import kendall_merge_tiles

    kernels = parent_src / "repro_torch" / "kernels"
    old_build = load_path("parent_build", kernels / "_build.py")
    old_km = load_path("parent_kendall_merge", kernels / "kendall_merge.py")
    old_build.build_all(["kendall_merge"])
    _build.build_all(["kendall_merge"])
    fns = {"parent": lambda u, kw: run_with(
               old_build, lambda: old_km.kendall_merge_tiles(u, 0, **kw)),
           "change": lambda u, kw: kendall_merge_tiles(u, 0, **kw)}
    print(f"merge-sort Kendall, parent {parent_src} and this tree in turns "
          f"[{where}]:")
    for label, u, kw in cases(x_tf, x_ties, ls=(96, 256, 512, 1024)):
        res, mem = {}, {}
        for who, fn in fns.items():
            fresh = u.clone()       # no rank structure cached yet
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            res[who] = fn(fresh, kw)
            torch.cuda.synchronize()
            out_b = res[who].numel() * 4
            mem[who] = ((torch.cuda.max_memory_allocated() - held) / 1e6,
                        (torch.cuda.memory_allocated() - held - out_b) / 1e6)
            del fresh
        if not torch.equal(res["parent"], res["change"]):
            raise AssertionError(f"{label}: this tree's kernel differs from "
                                 f"the parent's")
        del res
        times = {"parent": [], "change": []}
        for who in ("parent", "change", "change", "parent"):
            times[who].append(event_ms(lambda: fns[who](u, kw), 3))
        print(f"  {label} ({kw['pass_tiles']} tiles, one launch): parent "
              f"{times['parent'][0]:.3f} / {times['parent'][1]:.3f} ms, "
              f"change {times['change'][0]:.3f} / {times['change'][1]:.3f} "
              f"ms (bitwise equal); first call's peak / kept MB: parent "
              f"{mem['parent'][0]:.1f} / {mem['parent'][1]:.1f}, change "
              f"{mem['change'][0]:.1f} / {mem['change'][1]:.1f}")


def main(argv) -> int:
    import torch
    if argv[:1] not in ([], ["--parent"]) or len(argv) not in (0, 2):
        print("usage: kendall_ablation.py [--parent OTHER/src]",
              file=sys.stderr)
        return 2
    parent = Path(argv[1]).resolve() if argv else None
    if parent is not None and not (parent / "repro_torch").is_dir():
        print(f"kendall_ablation: no package at {parent / 'repro_torch'}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kendall_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.data.expression import ExpressionSpec, artificial

    where = card()
    print(where)
    dev = torch.device("cuda")
    x_tf = torch.from_numpy(artificial(ExpressionSpec(
        n=N_TF, l=L, seed=1))).to(dev)
    x_ties = torch.floor(8 * torch.from_numpy(artificial(ExpressionSpec(
        n=N_TF, l=L, seed=4))).to(dev))
    ablation(x_tf, x_ties)
    if parent is not None:
        against_parent(parent, x_tf, x_ties, where)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
