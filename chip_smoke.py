#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one H100

Phases, each fatal on failure:
  1. build every CUDA kernel from the sources in the checkout (nvcc, one
     process per source, all started together) and print ptxas' report;
  2. hold each kernel against its plain PyTorch version on the card, at
     small ragged shapes and at the main path's full shape;
  3. drive the main path, corr(x) at the paper's Table II shape (SEEK
     GPL570: n = 17,555 variables x l = 5,072 samples; artificial uniform
     data from seed 0, which the paper shows times like the real values),
     count the kernel's launches, and check the result: exact symmetry,
     64 sampled rows against float64, and bit-identity across pass splits;
  4. time the kernel, its bound, its plain version, one PyTorch library
     call for the same product, and corr end to end (CUDA events / host
     clock after torch.cuda.synchronize()).

The last line of stdout is {"ok": true, "device": {...}}; the line before
it holds one JSON record per kernel.  Without a CUDA device, or without the
rest of the repository beside it, the script exits non-zero before printing
any result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

N_SEEK, L_SEEK = 17_555, 5_072     # paper Table II (SEEK GPL570)
SPLIT = 300                        # 2,415 tiles = 8 x 300 + 15: ragged pass
SAMPLE_ROWS = 64
# Card peaks used for the bound (H100 SXM data sheet, at 700 W)
FP32_FLOPS = 67e12
HBM_BYTES_S = 3.35e12
# Kernel vs plain: the same float32 products summed in two orders.  Over
# l <= 1,024 samples the difference stays below the reference's own Pearson
# bound; over l_pad = 5,120 the diagonal's partial sums approach 1 and a
# rounding walk of ~sqrt(l) * 2^-24 ~ 4e-6 per path allows up to ~1e-5.
TOL_SMALL = 3e-6
TOL_FULL = 1e-5
# corr at float32 against float64 statistics and products on 64 rows.
TOL_F64 = 1e-5


def gpu_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def main() -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch

    from repro_torch.core import pcc
    from repro_torch.core.api import corr
    from repro_torch.core.plan import ExecutionPlan, pad_operands
    from repro_torch.data.expression import ExpressionSpec, artificial
    from repro_torch.kernels import _build
    from repro_torch.kernels.pcc_tile import (EpilogueSpec, pcc_tiles,
                                              pcc_tiles_plain)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # The plain versions' products must stay IEEE float32, never TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = gpu_info()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}; allow_tf32=False (matmul, cudnn)")

    # -- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build: {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "ptxas info" in line and ("Used" in line or "Compiling" in line):
                print(f"  {name}: {line.strip()}")

    # -- 2. kernel against plain --------------------------------------------
    def operand(x: torch.Tensor, t: int, l_blk: int) -> torch.Tensor:
        return pad_operands(pcc.transform(x, dtype=torch.float32), t, l_blk)

    def compare(u, j_start, t, l_blk, pass_tiles, spec, tol, label):
        got = pcc_tiles(u, j_start, t=t, l_blk=l_blk, pass_tiles=pass_tiles,
                        epilogue=spec)
        want = pcc_tiles_plain(u, j_start, t=t, l_blk=l_blk,
                               pass_tiles=pass_tiles, epilogue=spec)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        print(f"  {label}: max|kernel - plain| = {err:.3e} (tol {tol:g})")
        if not err <= tol:
            raise AssertionError(f"{label}: kernel disagrees with plain")
        if spec is not None:
            raw = pcc_tiles(u, j_start, t=t, l_blk=l_blk,
                            pass_tiles=pass_tiles)
            if not torch.equal(got, spec.apply(raw)):
                raise AssertionError(f"{label}: fused epilogue != unfused")
        return err

    epilogues = {"none": None, "clip": EpilogueSpec(clip=(-1.0, 1.0)),
                 "div_clip": EpilogueSpec(div=7.0, clip=(-0.05, 0.05))}
    rng = np.random.default_rng(0)
    small = [  # n, l, t, l_blk, j_start, pass_tiles
        (37, 29, 8, 8, 0, 15),        # every tile
        (37, 20, 8, 8, 12, 3),        # ragged pass, l_pad not a multiple of 16
        (37, 29, 8, 8, 13, 6),        # clamped ids past the end
        (300, 700, 96, 64, 1, 5),     # t not a multiple of the 64-row CTA
        (130, 300, 16, 64, 0, 45),
        (600, 1000, 256, 512, 0, 6),  # plan defaults, every tile
        (600, 1000, 256, 512, 4, 5),  # plan defaults, clamped
    ]
    max_err = 0.0
    print("kernel vs plain, small shapes:")
    for n, l, t, l_blk, j0, tiles in small:
        x = torch.from_numpy(rng.standard_normal((n, l)).astype(np.float32))
        u = operand(x.to(dev), t, l_blk)
        for name, spec in epilogues.items():
            max_err = max(max_err, compare(
                u, j0, t, l_blk, tiles, spec, TOL_SMALL,
                f"n={n} l={l} t={t} l_blk={l_blk} j0={j0} tiles={tiles} "
                f"{name}"))

    x_seek = artificial(ExpressionSpec(n=N_SEEK, l=L_SEEK, seed=0))
    x_dev = torch.from_numpy(x_seek).to(dev)
    plan = ExecutionPlan.create(N_SEEK, L_SEEK)
    u_seek = plan.prepare(x_dev)
    total = plan.total_tiles
    print(f"kernel vs plain, Table II operand {tuple(u_seek.shape)}, "
          f"{total} tiles:")
    max_err = max(max_err, compare(u_seek, 0, plan.t, plan.l_blk, total,
                                   plan.epilogue_spec, TOL_FULL,
                                   "full pass, Pearson epilogue"))
    max_err = max(max_err, compare(u_seek, total - 100, plan.t, plan.l_blk,
                                   SPLIT, None, TOL_FULL,
                                   "clamped pass, no epilogue"))

    # -- 3. the main path ---------------------------------------------------
    print(f"main path: corr(x) at n={N_SEEK} l={L_SEEK}, plan defaults "
          f"t={plan.t} l_blk={plan.l_blk}, {plan.n_pass} pass(es)")
    pcc_tiles.launches = 0
    r = corr(x_seek)
    torch.cuda.synchronize()
    launches = pcc_tiles.launches
    print(f"  pcc_tiles launches: {launches}")
    if launches < 1 or launches != plan.n_pass:
        raise AssertionError("corr did not run through the CUDA kernel")
    if r.shape != (N_SEEK, N_SEEK) or r.device.type != "cuda":
        raise AssertionError(f"bad result {tuple(r.shape)} on {r.device}")
    if not bool(torch.isfinite(r).all()):
        raise AssertionError("non-finite correlations")
    if not torch.equal(r, r.T):
        raise AssertionError("result is not exactly symmetric")
    rows = torch.as_tensor(np.sort(rng.choice(N_SEEK, SAMPLE_ROWS,
                                              replace=False)), device=dev)
    u64 = pcc.transform(x_dev.double())
    ref64 = torch.clamp(u64[rows] @ u64.T, -1.0, 1.0)
    err64 = float((r[rows].double() - ref64).abs().max())
    print(f"  {SAMPLE_ROWS} rows vs float64: max|d| = {err64:.3e} "
          f"(tol {TOL_F64:g})")
    if not err64 <= TOL_F64:
        raise AssertionError("corr disagrees with the float64 rows")
    del u64, ref64

    pcc_tiles.launches = 0
    r_split = corr(x_seek, max_tiles_per_pass=SPLIT)
    torch.cuda.synchronize()
    split_plan = ExecutionPlan.create(N_SEEK, L_SEEK, max_tiles_per_pass=SPLIT)
    print(f"  max_tiles_per_pass={SPLIT}: launch sizes "
          f"{split_plan.launch_sizes}, pcc_tiles launches "
          f"{pcc_tiles.launches}")
    if pcc_tiles.launches != split_plan.n_pass:
        raise AssertionError("split run did not launch once per pass")
    if not torch.equal(r, r_split):
        raise AssertionError("result depends on the pass split")
    del r_split

    x_small = rng.standard_normal((300, 200)).astype(np.float32)
    r_small = corr(x_small, t=64, l_blk=64, max_tiles_per_pass=4)
    want = np.corrcoef(x_small.astype(np.float64))
    err_small = float(np.abs(r_small.cpu().numpy() - want).max())
    print(f"  small corr (300 x 200) vs numpy float64: max|d| = "
          f"{err_small:.3e} (tol {TOL_SMALL:g})")
    if r_small.shape != (300, 300) or not err_small <= TOL_SMALL:
        raise AssertionError("small corr disagrees with numpy")

    # -- 4. times -----------------------------------------------------------
    def event_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times), times

    def host_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
        return statistics.median(times), times

    spec = plan.epilogue_spec
    kern_ms, kern_all = event_ms(lambda: pcc_tiles(
        u_seek, 0, t=plan.t, l_blk=plan.l_blk, pass_tiles=total,
        epilogue=spec), 5)
    plain_ms, plain_all = event_ms(lambda: pcc_tiles_plain(
        u_seek, 0, t=plan.t, l_blk=plan.l_blk, pass_tiles=total,
        epilogue=spec), 3)
    lib_ms, lib_all = event_ms(lambda: torch.matmul(u_seek, u_seek.T), 5)
    del r
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    corr_ms, corr_all = host_ms(lambda: corr(x_dev), 3)
    peak_gb = (torch.cuda.max_memory_allocated() - base_mem) / 1e9
    corr_np_ms, corr_np_all = host_ms(lambda: corr(x_seek), 3)

    flop = 2 * L_SEEK * plan.t * plan.t * total
    nbytes = u_seek.numel() * 4 + total * plan.t * plan.t * 4
    flop_ms = flop / FP32_FLOPS * 1e3
    byte_ms = nbytes / HBM_BYTES_S * 1e3
    bound_ms = max(flop_ms, byte_ms)
    bound_by = "operations" if flop_ms >= byte_ms else "bytes"
    tag = f"[{card}]"
    print(f"times at Table II shape {tag}:")
    print(f"  pcc_tiles, one pass of {total} tiles: {kern_ms:.3f} ms "
          f"(runs {[round(v, 3) for v in kern_all]}), "
          f"{flop / kern_ms / 1e9:.1f} TFLOP/s")
    print(f"  bound: {bound_ms:.3f} ms by {bound_by} ({flop:.4g} FLOP at "
          f"{FP32_FLOPS / 1e12:g} TFLOP/s = {flop_ms:.3f} ms; {nbytes:.4g} B "
          f"at {HBM_BYTES_S / 1e12:g} TB/s = {byte_ms:.3f} ms)")
    print(f"  pcc_tiles_plain: {plain_ms:.3f} ms "
          f"(runs {[round(v, 3) for v in plain_all]})")
    print(f"  library torch.matmul(u, u.T) {tuple(u_seek.shape)}, full "
          f"square: {lib_ms:.3f} ms (runs {[round(v, 3) for v in lib_all]})")
    print(f"  corr end to end, x on the card: {corr_ms:.3f} ms "
          f"(runs {[round(v, 3) for v in corr_all]}), peak "
          f"{peak_gb:.3f} GB above the {base_mem / 1e9:.3f} GB held")
    print(f"  corr end to end, x as host numpy: {corr_np_ms:.3f} ms "
          f"(runs {[round(v, 3) for v in corr_np_all]})")

    record = {"kernels": [{
        "name": "pcc_tiles", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/pcc_tile.cu",
        "replaces": "src/repro/kernels/pcc_tile.py:299",
        "launches": launches, "max_abs_err": max_err,
        "ms": kern_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": lib_ms}]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
