"""repro_torch — the LightPCC all-pairs engine in PyTorch for NVIDIA Hopper.

A port of the JAX package ``repro``, module for module (``repro_torch.core.api``
mirrors ``repro.core.api`` and so on).  Plain tensor code is PyTorch; the
tile, top-k and flash-attention kernels are hand-written CUDA C++ for
``sm_90a`` (``kernels/csrc``), built with ``nvcc`` at first use.  Entry points
run on ``cuda`` unless the caller passes ``device="cpu"`` (or CPU tensors),
where each kernel wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"
