"""Configurations: the paper's datasets (``lightpcc``) and the LM
architectures, resolved by ``--arch <id>`` for launchers and tests.

Port of ``repro/configs/__init__.py``.  The registry names every
architecture of the reference; those whose modules the port does not run
yet raise ``NotImplementedError`` naming their ROADMAP slice.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

# arch id -> module name, the architectures the port runs
ARCHS: Dict[str, str] = {
    "llama3.2-3b": "llama3_2_3b",
    "nemotron-4-340b": "nemotron_4_340b",
    "starcoder2-3b": "starcoder2_3b",
    "chatglm3-6b": "chatglm3_6b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "hymba-1.5b": "hymba_1_5b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "mixtral-8x22b": "mixtral_8x22b",
}
# arch id -> the ROADMAP slice that ports what it needs
LATER: Dict[str, str] = {
    "qwen2-vl-72b": "slice 12b part 3 (the VLM: mrope inputs, "
                    "embed_inputs)",
    "seamless-m4t-medium": "slice 12b part 4 (encoder-decoder)",
}


def list_archs() -> List[str]:
    """The architectures the port runs."""
    return list(ARCHS)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch in LATER:
        raise NotImplementedError(
            f"{arch} is not ported yet: ROADMAP {LATER[arch]}")
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    cfg = mod.SMOKE if smoke else mod.FULL
    cfg.validate()
    return cfg


def override(cfg: ModelConfig, **kw) -> ModelConfig:
    """dataclasses.replace with validation."""
    new = dataclasses.replace(cfg, **kw)
    new.validate()
    return new


__all__ = ["ARCHS", "LATER", "list_archs", "get_config", "override"]
