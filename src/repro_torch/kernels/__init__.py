"""Hand-written Hopper kernels and their plain PyTorch versions.

  pcc_tile.py         the tile kernel's and the top-k kernel's wrappers,
                      their plain versions and the fused EpilogueSpec
  narrow_gate.py      the gate holding the tensor-core tiles (bf16, fp8)
                      against the plain version, and its planted faults
  flash_attention.py  causal / sliding-window GQA flash attention: the
                      wrapper, its plain version, the mha_ref oracle and
                      grid_savings
  kendall_merge.py    merge-sort Kendall tiles (Knight's count): the
                      wrapper, its plain version, the rank structures
  ops.py              the public wrappers flash_mha and pcc_tiles
  csrc/pcc_accum.cuh  the SIMT 64 x 64 accumulation of the float32 and
                      int8 selects, tile ids, scales and the epilogue
  csrc/pcc_sgemm.cuh  the float32 tiles' SIMT mainloop (cp.async ring)
  csrc/cp_async.cuh   cp.async copies shared by the SIMT mainloops
  csrc/pcc_mma.cuh    the tensor-core tile mainloop the tile kernel and the
                      bf16 select share (bf16, fp8, int8): TMA ring,
                      wgmma, fp8 promotion, int8 int32 sums
  csrc/pcc_tile.cu    the all-pairs tile kernel, triangle and grid, with
                      per-row scales for quantized operands, float32 on the
                      SIMT pipes (sm_90a)
  csrc/pcc_tile_sm90.cu  the same, bf16, fp8 and int8 on the tensor cores
                      (persistent, wgmma, TMA; sm_90a)
  csrc/pcc_topk.cu    the per-row top-k kernels, select and merge (sm_90a;
                      the bf16 select on the tensor-core mainloop)
  csrc/flash_attention.cu  the flash-attention forward kernel, float32 on
                      the SIMT pipes (sm_90a)
  csrc/flash_attention_sm90.cu  the flash-attention forward kernel, bf16
                      and fp16 on the tensor cores: wgmma, TMA (sm_90a)
  csrc/kendall_merge.cu  merge-sort Kendall: a CTA per tile row, a
                      merge-path merge sort per pair in shared memory
                      (sm_90a)
  csrc/sm90.cuh       Hopper helpers: TMA tensor maps, mbarrier rings,
                      wgmma (bf16, fp16, fp8, int8)
  _build.py           nvcc build at first use, ctypes binding
"""
