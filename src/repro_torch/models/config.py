"""Model/config system: one dataclass drives every architecture.

Port of ``repro/models/config.py``: ``ModelConfig`` with every field of the
reference (the sharding and execution-policy fields included, so configs
compare field by field), its derived properties, ``validate`` and the shape
cells ``SHAPES``.  ``activation_dtype()`` gives a ``torch.dtype``.  The
dry-run stand-ins ``input_specs`` / ``cache_specs`` give tensors on the meta
device (shapes and dtypes, no storage) where the reference gives
``jax.ShapeDtypeStruct``s.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}

# ---------------------------------------------------------------------------
# Input-shape cells (assigned): name -> (seq_len, global_batch, kind)
# ---------------------------------------------------------------------------

SHAPES: Mapping[str, Tuple[int, int, str]] = {
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity
    arch: str = "unnamed"
    family: str = "dense"  # dense | moe | ssm | vlm | audio | hybrid

    # trunk
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0            # 0 -> d_model // n_heads
    d_ff: int = 1024
    vocab: int = 1024
    activation: str = "swiglu"   # swiglu | squared_relu | gelu
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    attn_bias: bool = False      # qkv bias (chatglm uses qkv bias)
    qk_norm: bool = False        # qwen3-style per-head RMSNorm on q/k

    # position encoding
    rope: str = "standard"       # standard | half (2d/chatglm) | mrope | none
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, ...] = (16, 24, 24)  # per-component pairs

    # attention extent
    window: int = 0              # 0 = full causal; >0 = sliding window tokens
    global_layer_stride: int = 0 # hybrid: every k-th layer is full-attn
    global_layers: Tuple[int, ...] = ()  # explicit full-attn layer ids

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # SSM (mamba1)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_dt_rank: int = 0         # 0 -> ceil(d_model / 16)
    ssm_chunk: int = 128         # chunked-scan length (memory/remat unit)

    # hybrid (hymba): attention and SSM heads run in parallel per layer
    hybrid: bool = False

    # encoder-decoder (seamless)
    enc_dec: bool = False
    n_enc_layers: int = 0        # 0 -> n_layers

    # modality frontend stubs ([vlm]/[audio]): inputs are embeddings
    embed_inputs: bool = False   # True -> input_specs gives (B, S, D) embeds

    # numerics
    dtype: str = "bfloat16"      # activation dtype
    param_dtype: str = "float32"
    logits_dtype: str = "float32"

    # execution policy
    scan_layers: bool = True
    remat: str = "block"         # none | block (checkpoint each layer)
    logits_chunk: int = 0        # 0 = unchunked loss; else tokens per chunk
    grad_accum: int = 1
    attn_impl: str = "xla"       # xla | causal_sliced (triangular prefix
    #                              slicing — the paper's C1 insight in static
    #                              XLA: chunk i's keys sliced to [0,(i+1)C))
    attn_chunk: int = 0          # q-chunked attention block (0 = dense)
    moe_impl: str = "global_sort"  # global_sort | per_example (batch-local
    #                                routing: sorts/scatters stay inside the
    #                                data shard -> no cross-device sort)
    analysis_unroll: bool = False  # unroll internal scans (roofline compile
    #                                only: exposes per-iteration FLOPs /
    #                                collectives that lax.scan hides from
    #                                cost_analysis; never used for execution)

    # sharding policy
    param_sharding: str = "tp"   # tp | fsdp_tp
    kv_cache_shard: str = "heads"  # heads | sequence
    seq_shard_activations: bool = False  # sequence-parallel residual stream
    opt_state_dtype: str = "float32"     # adam moment dtype (bf16 for 340B)

    # which shape cells this arch supports (long_500k only if sub-quadratic)
    shapes: Tuple[str, ...] = ("train_4k", "prefill_32k", "decode_32k")

    # --- derived -----------------------------------------------------------

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or -(-self.d_model // 16)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def enc_layers(self) -> int:
        return self.n_enc_layers or self.n_layers

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def uses_moe(self) -> bool:
        return self.n_experts > 0

    def layer_window(self, layer: int) -> int:
        """Effective attention window for a layer (0 = full causal)."""
        if self.window <= 0:
            return 0
        if layer in self.global_layers:
            return 0
        if self.global_layer_stride and layer % self.global_layer_stride == 0:
            return 0
        return self.window

    def layer_windows(self) -> Tuple[int, ...]:
        return tuple(self.layer_window(i) for i in range(self.n_layers))

    def param_count(self) -> int:
        """Exact parameter count from shapes (used for 6ND model FLOPs),
        counted on the meta device: nothing is allocated."""
        from repro_torch.models.registry import build_model  # lazy: cycle
        return build_model(self).param_count()

    def activation_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def validate(self) -> None:
        if self.n_heads and self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError(f"{self.arch}: H={self.n_heads} not a multiple "
                             f"of Hkv={self.n_kv_heads}")
        if self.uses_moe and (self.top_k <= 0 or self.moe_d_ff <= 0):
            raise ValueError(f"{self.arch}: MoE needs top_k and moe_d_ff")
        if self.family == "ssm" and self.ssm_state <= 0:
            raise ValueError(f"{self.arch}: ssm family needs ssm_state")
        for s in self.shapes:
            if s not in SHAPES:
                raise ValueError(f"{self.arch}: unknown shape cell {s}")


def input_specs(cfg: ModelConfig, shape: str,
                batch_override: Optional[int] = None) -> dict:
    """Meta-tensor stand-ins for every model input of a shape cell, under
    the step functions' keyword names: no storage is allocated.  Decode's
    ``cache`` is ``cache_specs``' structure and its ``cache_index`` a
    0-dim int32 meta tensor, as the reference's scalar spec."""
    if shape not in SHAPES:
        raise ValueError(f"unknown shape {shape}")
    if shape not in cfg.shapes:
        raise ValueError(f"{cfg.arch} does not support {shape} "
                         f"(see DESIGN.md SSArch-applicability)")
    seq, batch, kind = SHAPES[shape]
    return specs_at(cfg, seq, batch_override or batch, kind)


def specs_at(cfg: ModelConfig, seq: int, batch: int, kind: str) -> dict:
    """``input_specs`` of a cell given by its (seq, batch, kind) rather
    than a name of ``SHAPES`` (a cut-down cell on the card)."""
    i32 = torch.int32
    dt = cfg.activation_dtype()

    def meta(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    def tok(b, s):
        return meta((b, s), i32)

    specs: dict = {}
    if kind in ("train", "prefill"):
        if cfg.enc_dec:
            specs["src"] = meta((batch, seq, cfg.d_model), dt) \
                if cfg.embed_inputs else tok(batch, seq)
            specs["tokens"] = tok(batch, seq)
        elif cfg.embed_inputs:
            specs["embeds"] = meta((batch, seq, cfg.d_model), dt)
        else:
            specs["tokens"] = tok(batch, seq)
        if kind == "train":
            specs["labels"] = tok(batch, seq)
        if cfg.rope == "mrope":
            specs["positions"] = meta((batch, 3, seq), i32)
    else:  # decode: one new token against a cache of length seq
        specs["token"] = tok(batch, 1)
        specs["cache"] = cache_specs(cfg, batch, seq)
        specs["cache_index"] = meta((), i32)
        if cfg.rope == "mrope":
            specs["positions"] = meta((batch, 3, 1), i32)
    return specs


def cache_specs(cfg: ModelConfig, batch: int, seq: int):
    """The decode cache's structure on the meta device: the model's own
    ``steps.init_cache`` there, so the specs never drift from the real
    cache layout (window-bounded rings for SWA layers, O(1) SSM state)."""
    from repro_torch.models import steps  # lazy: config stays import-light
    return steps.init_cache(cfg, batch, seq, device="meta")


__all__ = ["ModelConfig", "SHAPES", "input_specs", "specs_at",
           "cache_specs"]
