"""minitron-4b [dense] — pruned Nemotron [arXiv:2407.14679].

32L d_model=3072 24H (GQA kv=8, head_dim=128) d_ff=9216 vocab=256000.
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="minitron-4b",
    arch_type="dense",
    n_layers=32,
    d_model=3072,
    vocab=256000,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    dtype="bfloat16",
)

SMOKE = FULL.replace(
    name="minitron-smoke",
    n_layers=2,
    d_model=192,
    vocab=512,
    n_heads=6,
    n_kv_heads=2,
    head_dim=32,
    d_ff=384,
    dtype="float32",
)
