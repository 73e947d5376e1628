"""qwen3-14b [dense] — qk-norm, GQA [hf:Qwen/Qwen3-8B family].

40L d_model=5120 40H (GQA kv=8, head_dim=128) d_ff=17408 vocab=151936.
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="qwen3-14b",
    arch_type="dense",
    n_layers=40,
    d_model=5120,
    vocab=151936,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    qk_norm=True,
    dtype="bfloat16",
)

SMOKE = FULL.replace(
    name="qwen3-smoke",
    n_layers=2,
    d_model=320,
    vocab=512,
    n_heads=5,
    n_kv_heads=1,
    head_dim=64,
    d_ff=640,
    qk_norm=True,
    dtype="float32",
)
