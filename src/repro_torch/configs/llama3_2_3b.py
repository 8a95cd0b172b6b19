"""llama3.2-3b  [dense]  28L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=128256  [hf:meta-llama/Llama-3.2-1B; unverified]

Pure full-attention arch -> long_500k skipped (DESIGN.md SS5).
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    arch="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=128_256,
    activation="swiglu",
    rope="standard",
    rope_theta=500_000.0,
    tie_embeddings=True,
    logits_chunk=512,
    attn_chunk=1024,
    seq_shard_activations=True,
    shapes=("train_4k", "prefill_32k", "decode_32k"),
)

SMOKE = ModelConfig(
    arch="llama3.2-3b-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab=512,
    activation="swiglu",
    rope="standard",
    rope_theta=500_000.0,
    tie_embeddings=True,
    dtype="float32",
)
