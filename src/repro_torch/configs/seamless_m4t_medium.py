"""seamless-m4t-medium  [audio]  12L d_model=1024 16H (GQA kv=16) d_ff=4096
vocab=256206 — enc-dec, multimodal  [arXiv:2308.11596; hf]

Encoder-decoder: 12 encoder layers over stubbed audio-frame embeddings
(input_specs supplies (B, S, d_model)) + 12 causal decoder layers with
cross-attention.  Decode = decoder step with cached encoder output, so the
decode shapes run (the arch is decoder-bearing).  vocab 256206 is not
16-divisible -> embeddings shard on d_model instead (sharding.py fallback).
Deviation noted: RoPE replaces the original relative-position scheme
(backbone stub; DESIGN.md SS5).  Full attention -> long_500k skipped.
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    arch="seamless-m4t-medium",
    family="audio",
    enc_dec=True,
    n_layers=12,
    n_enc_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab=256_206,
    activation="gelu",
    rope="standard",
    embed_inputs=True,
    tie_embeddings=False,
    logits_chunk=512,
    attn_chunk=1024,
    seq_shard_activations=True,
    shapes=("train_4k", "prefill_32k", "decode_32k"),
)

SMOKE = ModelConfig(
    arch="seamless-m4t-medium-smoke",
    family="audio",
    enc_dec=True,
    n_layers=2,
    n_enc_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    head_dim=32,
    d_ff=256,
    vocab=514,
    activation="gelu",
    rope="standard",
    embed_inputs=True,
    dtype="float32",
)
