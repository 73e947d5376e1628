"""zamba2-1.2b [hybrid] — Mamba2 backbone + one *shared* attention block
applied every 6 layers (weights shared, per-site KV cache) [arXiv:2411.15242].

38L d_model=2048, ssm_state=64; shared block: 32H (kv=32, head_dim=64),
d_ff=8192, vocab=32000.
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="zamba2-1.2b",
    arch_type="hybrid",
    n_layers=38,
    d_model=2048,
    vocab=32000,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_chunk=128,
    attn_every=6,
    dtype="bfloat16",
)

SMOKE = FULL.replace(
    name="zamba2-smoke",
    n_layers=2,
    d_model=256,
    vocab=512,
    n_heads=4,
    n_kv_heads=4,
    head_dim=64,
    d_ff=512,
    ssm_state=16,
    ssm_head_dim=32,
    ssm_chunk=16,
    attn_every=2,
    dtype="float32",
)
