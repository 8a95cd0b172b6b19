"""falcon-mamba-7b  [ssm]  64L d_model=4096 (attn-free) d_ff=0 vocab=65024,
ssm_state=16 — mamba1 arch  [arXiv:2410.05355; unverified]

Attention-free: the paper's triangular job-scheduling technique is
inapplicable to the core op (sequential scan — no pairwise job matrix);
implemented without it per the assignment (DESIGN.md SSArch-applicability).
O(1)-in-seq decode state -> long_500k runs.
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    arch="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=1,
    d_ff=0,
    vocab=65_024,
    ssm_state=16,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=256,
    rope="none",
    tie_embeddings=True,
    logits_chunk=512,
    seq_shard_activations=True,
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)

SMOKE = ModelConfig(
    arch="falcon-mamba-7b-smoke",
    family="ssm",
    n_layers=2,
    d_model=128,
    n_heads=0,
    n_kv_heads=1,
    d_ff=0,
    vocab=512,
    ssm_state=8,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=16,
    rope="none",
    tie_embeddings=True,
    dtype="float32",
)
