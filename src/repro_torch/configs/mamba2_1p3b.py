"""mamba2-1.3b [ssm] — SSD (state-space duality) [arXiv:2405.21060].

48L d_model=2048, attn-free, vocab=50280, ssm_state=128;
expand=2 -> d_inner=4096, head_dim=64 -> 64 SSD heads, 1 B/C group.
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="mamba2-1.3b",
    arch_type="ssm",
    n_layers=48,
    d_model=2048,
    vocab=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_chunk=128,
    d_conv=4,
    dtype="bfloat16",
)

SMOKE = FULL.replace(
    name="mamba2-smoke",
    n_layers=2,
    d_model=256,
    vocab=512,
    ssm_state=32,
    ssm_head_dim=32,
    ssm_chunk=16,
    dtype="float32",
)
