"""Model registry: build a family-dispatched Model facade from a config.

Port of ``repro/models/registry.py``: decoder-only configs (dense, MoE,
SSM, hybrid, the VLM) build ``transformer.DecoderLM``s, encoder-decoder
configs ``encdec.EncDecLM``s.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models import encdec, steps, transformer
from repro_torch.launch.mesh import mesh_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.parallel import Placement
from repro_torch.models.sharding import make_policy


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    @property
    def trunk(self):
        """The family's module: ``encdec`` or ``transformer``."""
        return encdec if self.cfg.enc_dec else transformer

    def init(self, generator: Optional[torch.Generator] = None,
             device=None, trainable: bool = False, mesh=None):
        """Parameters drawn from `generator` (default: seed 0 on `device`,
        itself "cuda" by default) onto its device; ``trainable`` leaves
        require grad.  With a (data, model) ``mesh`` every leaf is drawn
        whole on the first rank's device (the default generator's; the
        same draws as the one-device init), cut into the ranks' shards as
        ``sharding.make_policy(cfg, mesh)`` places them and freed: a
        ``parallel.ShardedLM`` holding exactly the one-device model's
        numbers."""
        place = None
        if mesh is not None:
            place = Placement(self.cfg, make_policy(self.cfg, mesh))
            device = place.devices[0]
        if generator is None:
            generator = torch.Generator(
                device=device if device is not None else "cuda")
            generator.manual_seed(0)
        if place is not None and mesh_device(generator.device) != device:
            raise ValueError(f"the generator lies on {generator.device}, "
                             f"the mesh's first rank on {device}")
        return self.trunk.init_params(generator, self.cfg, device,
                                      trainable, place=place)

    def init_shapes(self):
        """The parameters on the meta device: shapes, no allocation."""
        return self.trunk.init_params(None, self.cfg, "meta")

    def init_cache(self, batch: int, capacity: int, device=None):
        return steps.init_cache(self.cfg, batch, capacity, device=device)

    def forward(self, params, **kw):
        return self.trunk.forward(self.cfg, params, **kw)

    def param_count(self) -> int:
        return sum(p.numel() for p in self.init_shapes().parameters())

    def active_param_count(self) -> int:
        """MoE: params touched per token (experts scaled by top_k / E)."""
        cfg = self.cfg
        if not cfg.uses_moe:
            return self.param_count()
        total = 0
        for name, p in self.init_shapes().named_parameters():
            parts = name.split(".")
            n = p.numel()
            if "moe" in parts and parts[-1] in ("w1", "w2", "w3"):
                n = n * cfg.top_k // max(cfg.n_experts, 1)
            total += n
        return total


def build_model(cfg: ModelConfig) -> Model:
    cfg.validate()
    return Model(cfg)


__all__ = ["Model", "build_model"]
