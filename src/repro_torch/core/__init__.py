"""repro_torch.core — symmetric all-pairs Pearson: plan -> executor -> sink.

  api       corr(): the symmetric facade — THE entry point
  mapping   the tile-id <-> upper-triangle bijection
  tiling    tile geometry and pass partitioning
  pcc       the Eq. 4 row transform and dense oracles
  measures  the Measure record (Pearson)
  plan      ExecutionPlan: every static decision of a run
  allpairs  the double-buffered pass executor
  sinks     DenseSink: scatter tiles and mirror them
"""
