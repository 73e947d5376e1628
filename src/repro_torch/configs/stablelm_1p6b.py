"""stablelm-1.6b [dense] — [hf:stabilityai/stablelm-2-1_6b].

24L d_model=2048 32H (kv=32, head_dim=64) d_ff=5632 vocab=100352.
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="stablelm-1.6b",
    arch_type="dense",
    n_layers=24,
    d_model=2048,
    vocab=100352,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=5632,
    dtype="bfloat16",
)

SMOKE = FULL.replace(
    name="stablelm-smoke",
    n_layers=2,
    d_model=256,
    vocab=512,
    n_heads=4,
    n_kv_heads=4,
    head_dim=64,
    d_ff=512,
    dtype="float32",
)
