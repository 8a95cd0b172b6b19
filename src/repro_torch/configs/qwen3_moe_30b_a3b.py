"""qwen3-moe-30b-a3b  [moe]  48L d_model=2048 32H (GQA kv=4) d_ff=768
vocab=151936, MoE 128e top-8  [hf:Qwen/Qwen3-30B-A3B; hf]

128 experts shard expert-parallel over the 16-way model axis (8 experts per
chip); sort-based capacity routing (layers.moe_apply) keeps HLO FLOPs at the
active-parameter scale.  qk-norm per Qwen3.  long_500k skipped (full attn).
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    arch="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab=151_936,
    activation="swiglu",
    rope="standard",
    rope_theta=1_000_000.0,
    qk_norm=True,
    n_experts=128,
    top_k=8,
    moe_d_ff=768,
    tie_embeddings=False,
    logits_chunk=512,
    attn_chunk=1024,
    seq_shard_activations=True,
    shapes=("train_4k", "prefill_32k", "decode_32k"),
)

SMOKE = ModelConfig(
    arch="qwen3-moe-30b-a3b-smoke",
    family="moe",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=96,
    vocab=512,
    activation="swiglu",
    rope="standard",
    qk_norm=True,
    n_experts=8,
    top_k=2,
    moe_d_ff=96,
    dtype="float32",
)
