"""repro_torch.serving — corr() as a long-lived, request-batched service.

Port of ``repro.serving``: register an expression corpus once, then serve
interactive "m probes against the corpus" queries (the rectangular grid
workload) with the per-call costs of a one-shot ``corr()`` (row transform,
plan construction, per-launch overhead) spread over many requests:

  corpus.py      CorpusHandle: per-measure corpus transforms, computed once
                 and kept on the card (corr()'s TransformCache seam); live
                 mutation (``append`` / ``update``) with incremental
                 operand maintenance, a drift budget, generations and delta
                 subscriptions; the cached null state of significance
                 queries.
  live.py        running per-row moments, IncrementalOperand (O(delta l)
                 transform maintenance), LiveIndex (a standing all-pairs
                 result kept current by delta plans: the d-vs-n grid and
                 the d-vs-d triangle, never the full triangle; with
                 ``recovery=RetryPolicy()`` every launch self-heals).
  plan_cache.py  ProblemSpec / PlanCache: frozen plans keyed on bucketed
                 specs.
  batcher.py     Query / QueryBatcher: concurrent queries coalesced into
                 one padded grid launch, answers scattered per request
                 (dense rows through RowBlockSink, top-k through one
                 DeviceTopKSink or TopKSink).
  server.py      CorrServer: sync and async submission, the max-wait /
                 max-batch dispatcher thread, multi-corpus routing,
                 standing queries (``watch``), significance queries on the
                 cached null state, split-on-failure, deadlines and a
                 circuit breaker, per-request stats.

Answers are bitwise standalone ``corr()`` calls (batching and caching are
execution policy only), except within a live corpus's drift budget, where
incrementally maintained operands stay within DRIFT_TOL of a cold
transform.  Entry points default to the card (``device=None`` means
"cuda"); tests pass ``device="cpu"``.
"""

from repro_torch.serving.batcher import BatchInfo, Query, QueryBatcher
from repro_torch.serving.corpus import CorpusHandle, as_corpus
from repro_torch.serving.live import (DEFAULT_DRIFT_BUDGET, DRIFT_TOL, Delta,
                                      IncrementalOperand, LiveIndex,
                                      merge_row_moments, row_moments,
                                      supports_incremental,
                                      topk_rows_from_dense)
from repro_torch.serving.plan_cache import (PlanCache, ProblemSpec,
                                            bucket_rows, mesh_key)
from repro_torch.serving.server import (CorrServer, DeadlineExceeded,
                                        ServedResult, ServerOverloaded,
                                        WatchHandle)

__all__ = [
    "BatchInfo",
    "CorpusHandle",
    "CorrServer",
    "DEFAULT_DRIFT_BUDGET",
    "DRIFT_TOL",
    "DeadlineExceeded",
    "Delta",
    "IncrementalOperand",
    "LiveIndex",
    "PlanCache",
    "ProblemSpec",
    "Query",
    "QueryBatcher",
    "ServedResult",
    "ServerOverloaded",
    "WatchHandle",
    "as_corpus",
    "bucket_rows",
    "mesh_key",
    "merge_row_moments",
    "row_moments",
    "supports_incremental",
    "topk_rows_from_dense",
]
