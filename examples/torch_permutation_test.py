"""Permutation testing for correlation significance with the PyTorch port
(paper SSIV motivation).

    PYTHONPATH=src python examples/torch_permutation_test.py \
        [--device cpu] [--iterations 500]

The counterpart of examples/permutation_test.py for ``repro_torch``.  It
builds a dataset where genes 0 and 1 are truly co-expressed and the rest
are noise; the significance workload, ``corr(x, pvalues=...)`` with B
permuted replicas riding the replica axis of the tile kernel, must find
that planted pair as the most significant.  ``--device`` defaults to
``cuda`` (it raises without a card); ``--device cpu`` runs the kernels'
plain versions.  The permutations come from a CPU ``torch.Generator``
seeded with ``--seed``, not from ``jax.random``, so p-values differ from
the reference's by the null draw, not by the engine.
"""

import argparse

import numpy as np

from repro_torch.core import PermutationSpec, corr


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--n", type=int, default=24)
    ap.add_argument("--l", type=int, default=100)
    ap.add_argument("--iterations", type=int, default=500)
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    rng = np.random.default_rng(7)
    base = rng.standard_normal(args.l).astype(np.float32)
    x = rng.standard_normal((args.n, args.l)).astype(np.float32)
    x[0] = base
    x[1] = base + 0.2 * rng.standard_normal(args.l)

    spec = PermutationSpec(iterations=args.iterations, key=args.seed,
                           chunk=args.chunk)
    r, p = corr(x, pvalues=spec, device=args.device)
    r, p = r.cpu().numpy(), p.cpu().numpy()
    print(f"r[0,1]={r[0, 1]:+.3f}  p[0,1]={p[0, 1]:.4f}  "
          f"device={args.device}")
    off = p[np.triu_indices(args.n, k=1)]
    sig = (off < 0.01).sum()
    print(f"significant pairs at p<0.01: {sig} / {len(off)}")
    assert p[0, 1] < 0.01, "planted pair must be significant"
    assert p[0, 1] <= off.min(), "planted pair must be the most significant"
    # at p<0.01 over 276 pairs ~3 false positives are expected, and the
    # noise holds a few truly correlated pairs (multiple comparisons), so
    # the count is bounded rather than required to be zero
    assert sig <= max(3, int(0.03 * len(off))), "noise floods significance"
    print("OK")


if __name__ == "__main__":
    main()
