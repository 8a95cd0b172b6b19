"""repro_torch.core — all-pairs similarity, symmetric or X-vs-Y: plan ->
executor -> sink.

  api       corr(): the facade — THE entry point; the operand
            TransformCache and prepared_operand
  mapping   the tile-id <-> upper-triangle and rectangular-grid bijections
  tiling    tile geometry and pass partitioning
  pcc       the Eq. 4 row transform, dense oracles and the cost model
  measures  the Measure record, the row transforms, the registry and the
            masked (pairwise-complete) measures
  quantize  per-row absmax int8 / fp8 quantization and the Operand record
  plan      ExecutionPlan: every static decision of a run
  allpairs  the double-buffered pass executor, on one device or over a
            mesh (execute_plan(mesh=), MeshRun), its self-healing loop
            (execute_plan(recovery=RetryPolicy())), stream_tiles,
            assemble_from_stream and the deprecated drivers
  distributed  the deprecated mesh drivers allpairs_pcc_sharded{,_u}
  sinks     DenseSink, HostSink, ShardedHostSink (with ShardedMatrix,
            open_manifest and assemble), ReductionSink, EdgeCountSink,
            RowBlockSink, TopKSink, DeviceTopKSink, ExceedanceSink and the
            canonical top-k merge
  lru       the bounded LRU with hit / miss counters behind the caches
  significance  permutation / bootstrap p-values on the replica axis
            (corr(pvalues=PermutationSpec(...)))
  permutation   the deprecated permutation_pvalues wrapper

The public names below are the reference's ``repro.core`` exports,
resolved on first use: the kernel modules import ``core.mapping``, so
importing every module here would import them in a cycle.
"""

import importlib

_SUBMODULES = ("allpairs", "api", "distributed", "lru", "mapping",
               "measures", "pcc",
               "permutation", "plan", "quantize", "significance", "sinks",
               "tiling")

# public name -> (module, attribute)
_EXPORTS = {
    "corr": ("api", "corr"),
    "PairwiseProblem": ("api", "PairwiseProblem"),
    "TransformCache": ("api", "TransformCache"),
    "prepared_operand": ("api", "prepared_operand"),
    "prepared_cache_stats": ("api", "prepared_cache_stats"),
    "clear_prepared_cache": ("api", "clear_prepared_cache"),
    "allpairs_run": ("allpairs", "allpairs"),
    "stream_tiles": ("allpairs", "stream_tiles"),
    "assemble_from_stream": ("allpairs", "assemble_from_stream"),
    "allpairs_pcc": ("allpairs", "allpairs_pcc"),
    "allpairs_pcc_streamed": ("allpairs", "allpairs_pcc_streamed"),
    "allpairs_similarity": ("allpairs", "allpairs_similarity"),
    "allpairs_similarity_streamed": ("allpairs",
                                     "allpairs_similarity_streamed"),
    "allpairs_pcc_sharded": ("distributed", "allpairs_pcc_sharded"),
    "allpairs_pcc_sharded_u": ("distributed", "allpairs_pcc_sharded_u"),
    "ExecutionPlan": ("plan", "ExecutionPlan"),
    "PermutationSpec": ("significance", "PermutationSpec"),
    "dense_significance_reference": ("significance",
                                     "dense_significance_reference"),
    "LruStatsCache": ("lru", "LruStatsCache"),
    "TileSink": ("sinks", "TileSink"),
    "DenseSink": ("sinks", "DenseSink"),
    "HostSink": ("sinks", "HostSink"),
    "ReductionSink": ("sinks", "ReductionSink"),
    "EdgeCountSink": ("sinks", "EdgeCountSink"),
    "RowBlockSink": ("sinks", "RowBlockSink"),
    "ExceedanceSink": ("sinks", "ExceedanceSink"),
    "TopKSink": ("sinks", "TopKSink"),
    "DeviceTopKSink": ("sinks", "DeviceTopKSink"),
    "Measure": ("measures", "Measure"),
    "dense_reference": ("measures", "dense_reference"),
    "pearson_gemm": ("pcc", "pearson_gemm"),
    "pearson_literal": ("pcc", "pearson_literal"),
    "transform": ("pcc", "transform"),
}

__all__ = list(_SUBMODULES) + list(_EXPORTS)


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module, attr = _EXPORTS[name]
    value = getattr(importlib.import_module(f"{__name__}.{module}"), attr)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
