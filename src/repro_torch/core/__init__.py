"""repro_torch.core — all-pairs similarity, symmetric or X-vs-Y: plan ->
executor -> sink.

  api       corr(): the facade — THE entry point
  mapping   the tile-id <-> upper-triangle and rectangular-grid bijections
  tiling    tile geometry and pass partitioning
  pcc       the Eq. 4 row transform and dense oracles
  measures  the Measure record, the row transforms, the registry and the
            masked (pairwise-complete) measures
  quantize  per-row absmax int8 / fp8 quantization and the Operand record
  plan      ExecutionPlan: every static decision of a run
  allpairs  the double-buffered pass executor
  sinks     DenseSink, TopKSink, DeviceTopKSink, ExceedanceSink and the
            canonical top-k merge
  significance  permutation / bootstrap p-values on the replica axis
            (corr(pvalues=PermutationSpec(...)))
  permutation   the deprecated permutation_pvalues wrapper
"""
