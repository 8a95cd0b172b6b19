"""hymba-1.5b  [hybrid]  32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attn+mamba heads  [arXiv:2411.13676; hf]

Each layer runs attention and a mamba-1 SSM in parallel on the same
pre-norm input (summed outputs).  Per the Hymba paper, 3 layers (first /
middle / last) use global attention, the rest SWA — the mixed window
pattern exercises the run-grouped scan (transformer.layer_runs -> 5 runs)
and per-run decode caches.  SWA + O(1) SSM state -> long_500k runs; the 3
global layers keep full-context caches (1.3 GB total at 500k, B=1 — fits).
vocab 32001 is odd -> embeddings shard on d_model (sharding.py fallback).
Meta-tokens from the paper are out of backbone scope (stub note).
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    arch="hymba-1.5b",
    family="hybrid",
    hybrid=True,
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab=32_001,
    activation="swiglu",
    rope="standard",
    window=1024,
    global_layers=(0, 15, 31),
    ssm_state=16,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=256,
    tie_embeddings=True,
    logits_chunk=512,
    attn_chunk=1024,
    seq_shard_activations=True,
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)

SMOKE = ModelConfig(
    arch="hymba-1.5b-smoke",
    family="hybrid",
    hybrid=True,
    n_layers=4,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab=513,
    activation="swiglu",
    rope="standard",
    window=32,
    global_layers=(0, 3),
    ssm_state=8,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=16,
    tie_embeddings=True,
    dtype="float32",
)
