"""qwen2-vl-72b  [vlm]  80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 — M-RoPE, dynamic resolution  [arXiv:2409.12191; hf]

Backbone only: the vision frontend is a stub —
input_specs() supplies precomputed patch embeddings (B, S, d_model) and
(B, 3, S) M-RoPE position triples (t, h, w).  72B params -> FSDP+TP.
Full attention -> long_500k skipped.
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    arch="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29_568,
    vocab=152_064,
    activation="swiglu",
    rope="mrope",
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),
    embed_inputs=True,
    attn_bias=True,
    tie_embeddings=False,
    logits_chunk=512,
    attn_chunk=1024,
    param_sharding="fsdp_tp",
    kv_cache_shard="sequence",
    seq_shard_activations=True,
    shapes=("train_4k", "prefill_32k", "decode_32k"),
)

SMOKE = ModelConfig(
    arch="qwen2-vl-72b-smoke",
    family="vlm",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab=512,
    activation="swiglu",
    rope="mrope",
    mrope_sections=(4, 6, 6),
    embed_inputs=True,
    attn_bias=True,
    dtype="float32",
)
