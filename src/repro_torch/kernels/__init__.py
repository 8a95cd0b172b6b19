"""Hand-written Hopper kernels and their plain PyTorch versions.

  pcc_tile.py         the tile kernel's and the top-k kernel's wrappers,
                      their plain versions and the fused EpilogueSpec
  flash_attention.py  causal / sliding-window GQA flash attention: the
                      wrapper, its plain version, the mha_ref oracle and
                      grid_savings
  ops.py              the public wrappers flash_mha and pcc_tiles
  csrc/pcc_accum.cuh  the tile accumulation both CUDA kernels share, one
                      routine per operand type (float32, bf16, fp8, int8)
  csrc/pcc_tile.cu    the all-pairs tile kernel, triangle and grid, with
                      per-row scales for quantized operands (sm_90a)
  csrc/pcc_topk.cu    the per-row top-k kernels, select and merge (sm_90a)
  csrc/flash_attention.cu  the flash-attention forward kernel, float32 on
                      the SIMT pipes (sm_90a)
  csrc/flash_attention_sm90.cu  the flash-attention forward kernel, bf16
                      and fp16 on the tensor cores: wgmma, TMA (sm_90a)
  csrc/sm90.cuh       Hopper helpers: TMA tensor maps, mbarriers, wgmma
  _build.py           nvcc build at first use, ctypes binding
"""
