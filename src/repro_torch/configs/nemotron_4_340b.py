"""nemotron-4-340b  [dense]  96L d_model=18432 96H (GQA kv=8) d_ff=73728
vocab=256000 — GQA, squared-ReLU  [arXiv:2402.16819; unverified]

The 340B-param stress case: full FSDP+TP param sharding, bf16 Adam moments,
sequence-parallel residual stream, sequence-sharded KV cache, micro-batched
gradient accumulation.  See EXPERIMENTS.md SSDry-run for the per-chip bytes.
Pure full-attention -> long_500k skipped.
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    arch="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18_432,
    n_heads=96,
    n_kv_heads=8,
    head_dim=192,
    d_ff=73_728,
    vocab=256_000,
    activation="squared_relu",
    rope="standard",
    rope_theta=10_000.0,
    tie_embeddings=False,
    logits_chunk=512,
    attn_chunk=1024,
    grad_accum=4,
    param_sharding="fsdp_tp",
    kv_cache_shard="sequence",
    seq_shard_activations=True,
    opt_state_dtype="bfloat16",
    shapes=("train_4k", "prefill_32k", "decode_32k"),
)

SMOKE = ModelConfig(
    arch="nemotron-4-340b-smoke",
    family="dense",
    n_layers=2,
    d_model=192,
    n_heads=6,
    n_kv_heads=2,
    head_dim=32,
    d_ff=768,
    vocab=512,
    activation="squared_relu",
    rope="standard",
    grad_accum=2,
    dtype="float32",
)
