"""Configurations: the paper's datasets (``lightpcc``) and the LM
architectures, resolved by ``--arch <id>`` for launchers and tests.

Port of ``repro/configs/__init__.py``: the registry names every
architecture of the reference, and the port runs each of them.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

# arch id -> module name, in the reference's order
ARCHS: Dict[str, str] = {
    "llama3.2-3b": "llama3_2_3b",
    "nemotron-4-340b": "nemotron_4_340b",
    "starcoder2-3b": "starcoder2_3b",
    "chatglm3-6b": "chatglm3_6b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "mixtral-8x22b": "mixtral_8x22b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "hymba-1.5b": "hymba_1_5b",
}


def list_archs() -> List[str]:
    """The architectures the port runs."""
    return list(ARCHS)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
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


__all__ = ["ARCHS", "list_archs", "get_config", "override"]
