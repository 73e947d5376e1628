"""yi-34b [dense] — llama-arch GQA [arXiv:2403.04652].

60L d_model=7168 56H (GQA kv=8, head_dim=128) d_ff=20480 vocab=64000.
One node model on one card: the smoke variant, or full width at a cut depth.
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="yi-34b",
    arch_type="dense",
    n_layers=60,
    d_model=7168,
    vocab=64000,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    dtype="bfloat16",
)

SMOKE = FULL.replace(
    name="yi-smoke",
    n_layers=2,
    d_model=224,
    vocab=512,
    n_heads=7,
    n_kv_heads=1,
    head_dim=32,
    d_ff=448,
    dtype="float32",
)
