"""mixtral-8x22b  [moe]  56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8e top-2, SWA  [arXiv:2401.04088; hf]

8 experts < 16-way model axis -> intra-expert tensor parallelism (d_ff=16384
divides 16).  Sliding window 4096 bounds the decode KV ring buffer, so
long_500k runs (sub-quadratic) — the banded bijection (core.mapping
band_lower_*) enumerates its attention job matrix.
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    arch="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16_384,
    vocab=32_768,
    activation="swiglu",
    rope="standard",
    rope_theta=1_000_000.0,
    window=4096,
    n_experts=8,
    top_k=2,
    moe_d_ff=16_384,
    tie_embeddings=False,
    logits_chunk=512,
    attn_chunk=1024,
    param_sharding="fsdp_tp",
    seq_shard_activations=True,
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)

SMOKE = ModelConfig(
    arch="mixtral-8x22b-smoke",
    family="moe",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab=512,
    activation="swiglu",
    rope="standard",
    window=32,
    n_experts=4,
    top_k=2,
    moe_d_ff=256,
    dtype="float32",
)
