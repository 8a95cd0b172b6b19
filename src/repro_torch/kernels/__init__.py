"""Hand-written Hopper kernels and their plain PyTorch versions.

  pcc_tile.py      the triangular all-pairs tile kernel's wrapper, its plain
                   version and the fused EpilogueSpec
  csrc/pcc_tile.cu the CUDA C++ kernel (sm_90a)
  _build.py        nvcc build at first use, ctypes binding
"""
