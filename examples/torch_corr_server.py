"""Interactive co-expression query serving with the PyTorch port.

    PYTHONPATH=src python examples/torch_corr_server.py \
        [--device cpu] [--n 400] [--l 120] [--clients 6] [--queries 4] \
        [--topk 5]

The counterpart of examples/corr_server.py for ``repro_torch``.  The batch
workflow (examples/torch_coexpression_network.py) computes the whole
network once; this demo shows the other production shape: the corpus is
registered with a long-lived ``CorrServer`` and many concurrent clients ask
small questions ("which corpus genes co-express with these probes?") as
m-probes-against-corpus queries.

What the serving layer buys (printed at the end):

  * the corpus row transform runs once per measure (CorpusHandle cache),
    not once per query;
  * concurrent queries coalesce into shared launches (QueryBatcher, the
    max-wait / max-batch policy), so launches < requests;
  * repeat query shapes hit the PlanCache.

Every answer is bitwise a standalone ``corr(probes, corpus)`` call
(asserted for one query).  ``--device`` defaults to ``cuda`` (it raises
without a card); ``--device cpu`` runs the kernels' plain versions.
"""

import argparse
import threading

import numpy as np

from repro_torch.core import corr
from repro_torch.core.sinks import TopKSink
from repro_torch.data.expression import ExpressionSpec, coexpressed
from repro_torch.serving import CorrServer

T, LBLK = 32, 64


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--n", type=int, default=400, help="corpus genes")
    ap.add_argument("--l", type=int, default=120, help="samples")
    ap.add_argument("--clients", type=int, default=6,
                    help="concurrent client threads")
    ap.add_argument("--queries", type=int, default=4,
                    help="queries per client")
    ap.add_argument("--topk", type=int, default=5, metavar="K",
                    help="per-row top-K strongest |r| partners per query")
    ap.add_argument("--max-wait-ms", type=float, default=20.0,
                    help="batching window: how long a request waits for "
                         "batch-mates before its launch goes out")
    args = ap.parse_args()

    corpus = coexpressed(ExpressionSpec(n=args.n, l=args.l, seed=1))
    rng = np.random.default_rng(2)
    requests = [[rng.standard_normal((int(rng.integers(1, 6)), args.l))
                 .astype(np.float32) for _ in range(args.queries)]
                for _ in range(args.clients)]
    answers = [[None] * args.queries for _ in range(args.clients)]

    with CorrServer(corpus, t=T, l_blk=LBLK, device=args.device,
                    max_wait_s=args.max_wait_ms / 1e3) as srv:
        def client(c):
            for q, probes in enumerate(requests[c]):
                answers[c][q] = srv.query(probes, k=args.topk, timeout=120)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(args.clients)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        stats = srv.stats()

    # spot check: the served answer is a standalone corr()'s, bit for bit
    ref = corr(requests[0][0], corpus, t=T, l_blk=LBLK, device=args.device,
               sink=TopKSink(args.topk))
    got = answers[0][0].value
    np.testing.assert_array_equal(got["indices"], ref["indices"])
    np.testing.assert_array_equal(got["values"], ref["values"])

    total = args.clients * args.queries
    waits = [a.stats["queue_s"] * 1e3 for row in answers for a in row]
    occs = [a.stats["batch_occupancy"] for row in answers for a in row]
    pc = stats["plan_cache"]
    print(f"corpus n={args.n} genes x l={args.l} samples; {args.clients} "
          f"clients x {args.queries} queries (top-{args.topk}), "
          f"device={args.device}")
    print(f"requests={stats['requests']}  launches={stats['batches']}  "
          f"coalescing={stats['requests'] / max(stats['batches'], 1):.1f} "
          f"req/launch")
    print(f"queue wait: mean={np.mean(waits):.1f}ms  max={np.max(waits):.1f}"
          f"ms  mean batch occupancy={np.mean(occs):.2f}")
    print(f"plan cache: {pc['hits']} hits / {pc['misses']} misses "
          f"(size {pc['size']})")
    print(f"corpus transforms run: {stats['corpus']['misses']} (one per "
          f"measure; {stats['corpus']['hits']} launches reused it)")
    assert stats["requests"] == total
    assert stats["batches"] <= total
    assert stats["corpus"]["misses"] == 1
    print("OK — served answers bit-identical to standalone corr(); "
          "corpus transformed once; queries coalesced into shared launches")


if __name__ == "__main__":
    main()
