"""The LM side of the port: decoder-only prefill and decode.

  config.py       ModelConfig + shape cells
  layers.py       norms / RoPE variants / GQA+SWA attention / MLPs / MoE
  ssm.py          mamba-1 chunked selective scan + O(1) decode
  transformer.py  decoder-only trunk (run-grouped loop over layers)
  steps.py        prefill / decode step builders
  registry.py     build_model(cfg) facade

Port of ``repro/models`` for the dense, MoE, SSM and hybrid families; the
VLM, encoder-decoder, sharding and training are later slices (ROADMAP A).
"""

from repro_torch.models.config import SHAPES, ModelConfig
from repro_torch.models.registry import Model, build_model

__all__ = ["ModelConfig", "SHAPES", "Model", "build_model"]
