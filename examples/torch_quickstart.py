"""Quickstart: pairwise correlation with the PyTorch port on an NVIDIA GPU.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The counterpart of examples/quickstart.py for ``repro_torch``.  It shows
the API levels of the ``corr()`` facade:
  1. symmetric all-pairs: one call, the triangular tile kernel under the
     hood (the paper's workload),
  2. rectangular X-vs-Y cross-correlation (grid workload, second operand),
  3. masked pairwise-complete correlation over missing data (``where=``),
  4. streaming out-of-core assembly through a HostSink, and the raw pass
     stream assembled on the host,
  5. the bijective job mappings themselves (the paper's framework
     contribution, one per workload).

``--device`` defaults to ``cuda`` (the hand-written kernels; it raises
without a card); ``--device cpu`` runs the kernels' plain versions.
"""

import argparse

import numpy as np
import torch

from repro_torch.core import mapping, tiling
from repro_torch.core.allpairs import (assemble_from_stream,
                                       resolve_device, stream_tiles)
from repro_torch.core.api import corr
from repro_torch.core.measures import dense_reference_pair
from repro_torch.core.pcc import pearson_gemm
from repro_torch.core.sinks import HostSink


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args()
    dev = resolve_device(args.device)    # raises without a card for cuda

    rng = np.random.default_rng(0)
    n, l = 96, 64
    x = torch.from_numpy(rng.standard_normal((n, l)).astype(np.float32)) \
        .to(dev)

    # 1. symmetric all-pairs: transform (Eq. 4) + triangular tiles
    #    (Alg. 1) + assembly, in one call
    r = corr(x, t=16, l_blk=32, device=dev)
    print(f"R shape={tuple(r.shape)}  diag_max_err="
          f"{float((torch.diagonal(r) - 1).abs().max()):.2e}  "
          f"vs_oracle={float((r - pearson_gemm(x)).abs().max()):.2e}")

    # 2. rectangular: m query profiles against the corpus; only the
    #    (m_rows x m_cols) tile grid is computed, nothing mirrored
    q = torch.from_numpy(rng.standard_normal((24, l)).astype(np.float32)) \
        .to(dev)
    rq = corr(q, x, t=16, l_blk=32, device=dev)
    print(f"rect shape={tuple(rq.shape)}  vs_oracle="
          f"{float((rq - dense_reference_pair(q, x)).abs().max()):.2e}")

    # 3. masked: correlate despite missing samples; each pair is scored
    #    over its common observed support (pairwise-complete)
    xm = x.cpu().numpy().copy()
    xm[rng.random(xm.shape) < 0.2] = np.nan
    rm = corr(xm, where="nan", t=16, l_blk=32, device=dev)
    print(f"masked shape={tuple(rm.shape)}  nan_frac=0.2  diag_max_err="
          f"{float((torch.diagonal(rm) - 1).abs().max()):.2e}")

    # 4. streamed multi-pass out-of-core (paper Alg. 2: double-buffered
    #    passes into a host-side sink; add path=... for a memmap with
    #    durable per-pass checkpoints + corr(resume_from=...)), and the
    #    raw pass stream assembled on the host
    r2 = corr(x, t=16, l_blk=32, max_tiles_per_pass=6, sink=HostSink(),
              device=dev)
    plan = tiling.TilePlan.create(n, l, 16)
    r3 = assemble_from_stream(n, 16, plan.m, stream_tiles(
        x, t=16, l_blk=32, max_tiles_per_pass=6, device=dev))
    r_host = r.cpu().numpy()
    print(f"streamed assembly matches: {np.allclose(r2, r_host, atol=1e-5)}"
          f"  raw stream bitwise: {np.array_equal(r3, r_host)}")
    assert np.array_equal(r2, r_host) and np.array_equal(r3, r_host)

    # 5. the bijections: job id <-> coordinate, one family per workload
    for j in (0, 7, plan.total_tiles - 1):
        y, t_x = mapping.job_coord(plan.m, j)
        back = mapping.job_id(plan.m, y, t_x)
        print(f"tri  tile id {j:3d} <-> coord ({y}, {t_x})  roundtrip={back}")
    grid = mapping.GridWorkload(m_rows=2, m_cols=plan.m)
    ys, xs = grid.job_coord_batch([0, 5, grid.job_count - 1])
    print(f"grid tile ids (0, 5, {grid.job_count - 1}) <-> coords "
          f"{list(zip(ys.tolist(), xs.tolist()))}")


if __name__ == "__main__":
    main()
