"""chatglm3-6b  [dense]  28L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=65024 — RoPE 2d, GQA  [arXiv:2406.12793; hf]

2d-RoPE = rotary applied to the first half of each head dim only
(rope="half").  QKV bias per the GLM lineage.  long_500k skipped.
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    arch="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13_696,
    vocab=65_024,
    activation="swiglu",
    rope="half",
    rope_theta=10_000.0,
    attn_bias=True,
    tie_embeddings=False,
    logits_chunk=512,
    attn_chunk=1024,
    seq_shard_activations=True,
    shapes=("train_4k", "prefill_32k", "decode_32k"),
)

SMOKE = ModelConfig(
    arch="chatglm3-6b-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab=512,
    activation="swiglu",
    rope="half",
    attn_bias=True,
    dtype="float32",
)
