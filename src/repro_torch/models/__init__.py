"""The LM side of the port: training, prefill and decode.

  config.py       ModelConfig + shape cells
  layers.py       norms / RoPE variants / GQA+SWA attention / MLPs / MoE
  ssm.py          mamba-1 chunked selective scan + O(1) decode
  transformer.py  decoder-only trunk (run-grouped loop over layers)
  encdec.py       encoder-decoder trunk
  sharding.py     ShardingPolicy: the reference's specs over a port Mesh
  parallel.py     the executor of a placement over a (data, model) mesh
  steps.py        train / prefill / decode step builders
  registry.py     build_model(cfg) facade

Port of ``repro/models`` for every family (dense, MoE, SSM, hybrid, the
VLM and the encoder-decoder).  Serving executes a placement over a model
axis and FSDP (``parallel.py``); training over one is the training half
of ROADMAP A part 5.
"""

from repro_torch.models.config import SHAPES, ModelConfig
from repro_torch.models.registry import Model, build_model

__all__ = ["ModelConfig", "SHAPES", "Model", "build_model"]
