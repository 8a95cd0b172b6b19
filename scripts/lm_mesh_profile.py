#!/usr/bin/env python3
"""Where a prefill's time goes over a model axis, on one NVIDIA GPU.

    python3 scripts/lm_mesh_profile.py [--ranks 4] [--prompt 4096]

llama3.2-3b FULL (random float32 parameters, seed 0, bf16 activations)
prefills one prompt of --prompt tokens on cuda:0 alone and over a (1,
--ranks) mesh of logical ranks on cuda:0 (models/parallel.py).  Each run
is timed on the host clock to a synchronised card (median of 3 after a
warm-up), then traced once by torch.profiler: the kernels' summed time on
the card, the operators' own time on the host, the count of aten calls,
and the ten operators whose kernels take the most card time.  The
mesh's collectives are timed apart with CUDA events
(``Placement.timer``).  Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=4096)
    args = ap.parse_args(argv)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import steps
    from repro_torch.models.registry import build_model

    if not torch.cuda.is_available():
        print("lm_mesh_profile: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card())
    dev = torch.device("cuda", 0)
    cfg = get_config("llama3.2-3b")
    toks = torch.randint(0, cfg.vocab, (1, args.prompt), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(2))
    mesh = make_mesh((1, args.ranks), ("data", "model"),
                     devices=[dev] * args.ranks)
    for label, on_mesh in (("one device", False),
                           (f"(1, {args.ranks}) mesh", True)):
        params = build_model(cfg).init(
            torch.Generator(device=dev).manual_seed(0), device=dev,
            mesh=mesh if on_mesh else None)
        policy = params.policy if on_mesh else None
        prefill = steps.make_prefill_step(
            cfg, cache_capacity=args.prompt + 1, policy=policy)

        def run():
            prefill(params, tokens=toks)

        run()
        torch.cuda.synchronize()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        coll = ""
        if on_mesh:
            params.px.timer = []
            run()
            coll = (f"; collectives {params.px.collective_ms():.3f} ms in "
                    f"{len(params.px.timer)}")
            params.px.timer = None
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        events = prof.key_averages()
        kernels = [e for e in events if e.device_type == DeviceType.CUDA]
        ops = [e for e in events if e.device_type == DeviceType.CPU]
        dev_us = sum(e.self_device_time_total for e in kernels)
        host_us = sum(e.self_cpu_time_total for e in ops)
        n_ops = sum(e.count for e in ops if e.key.startswith("aten::"))
        print(f"{label}: prefill of {args.prompt} {statistics.median(times):.3f}"
              f" ms (runs {', '.join(f'{t:.3f}' for t in times)}); traced: "
              f"kernels {dev_us / 1e3:.3f} ms on the card, operators "
              f"{host_us / 1e3:.3f} ms on the host, {n_ops} aten calls"
              f"{coll}")
        # each operator with the card time of the kernels it launched
        top = sorted(ops, key=lambda e: -e.self_device_time_total)[:10]
        for e in top:
            print(f"    {e.key[:40]:40s} card "
                  f"{e.self_device_time_total / 1e3:9.3f} ms  calls "
                  f"{e.count:6d}  host {e.self_cpu_time_total / 1e3:9.3f} ms")
        del params, prefill
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
