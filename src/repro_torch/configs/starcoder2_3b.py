"""starcoder2-3b  [dense]  30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152 — GQA, RoPE  [arXiv:2402.19173; hf]

kv=2 is the extreme-GQA case: the KV projection dim (256) still divides the
16-way model axis, but per-head TP is fractional — the dry-run exercises
GSPMD's uneven head propagation.  Pure full-attention -> long_500k skipped.
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    arch="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    head_dim=128,
    d_ff=12_288,
    vocab=49_152,
    activation="gelu",
    rope="standard",
    rope_theta=999_999.0,
    attn_bias=True,
    tie_embeddings=True,
    logits_chunk=512,
    attn_chunk=1024,
    seq_shard_activations=True,
    shapes=("train_4k", "prefill_32k", "decode_32k"),
)

SMOKE = ModelConfig(
    arch="starcoder2-3b-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=512,
    vocab=512,
    activation="gelu",
    rope="standard",
    attn_bias=True,
    tie_embeddings=True,
    dtype="float32",
)
