"""The paper's own workload configs: all-pairs PCC datasets + kernel tiling.

Copy of ``repro/configs/lightpcc.py``.  Mirrors the evaluation in SSIV:
  * artificial datasets: n in {16K, 32K, 64K}, l = 5K (Table I)
  * real dataset: SEEK GPL570, n = 17,555 genes x l = 5,072 samples (Table II)
  * scalability sweep: 1..16 accelerators (Fig. 2)

`t` and `l_blk` are the plan's logical tile and sample block; the CUDA
kernel picks its own CTA block inside a tile.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PCCConfig:
    name: str
    n: int                      # variables (gene expression profiles)
    l: int                      # samples per variable
    t: int = 256                # logical tile side
    l_blk: int = 512            # sample-axis block
    dtype: str = "float32"
    max_tiles_per_pass: int = 4096   # multi-pass bound (C4)
    devices: int = 16           # paper: up to 16 Xeon Phis


# Paper Table I (artificial, l = 5K)
ARTIFICIAL_16K = PCCConfig("artificial_16k", n=16_000, l=5_000)
ARTIFICIAL_32K = PCCConfig("artificial_32k", n=32_000, l=5_000)
ARTIFICIAL_64K = PCCConfig("artificial_64k", n=64_000, l=5_000)

# Paper Table II (real SEEK GPL570 dataset shape)
REAL_SEEK = PCCConfig("real_seek", n=17_555, l=5_072)

TABLES = {
    "table1": (ARTIFICIAL_16K, ARTIFICIAL_32K, ARTIFICIAL_64K),
    "table2": (REAL_SEEK,),
}


def flops(cfg: PCCConfig) -> int:
    """Paper SSIII-E cost model in FMA 'unit operations':
    5 l n (transform) + l n(n+1)/2 (all-pairs)."""
    return 5 * cfg.l * cfg.n + cfg.l * cfg.n * (cfg.n + 1) // 2


__all__ = ["PCCConfig", "TABLES", "flops", "ARTIFICIAL_16K",
           "ARTIFICIAL_32K", "ARTIFICIAL_64K", "REAL_SEEK"]
