"""internvl2-2b [vlm] — InternViT + InternLM2 backbone [arXiv:2404.16821].

Backbone: 24L d_model=2048 16H (GQA kv=8, head_dim=128) d_ff=8192
vocab=92553.  The InternViT vision encoder + MLP projector are STUBBED per
spec: `input_specs()` provides precomputed patch embeddings
[B, 256, 1024]; the model owns only the projection into d_model.
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="internvl2-2b",
    arch_type="vlm",
    n_layers=24,
    d_model=2048,
    vocab=92553,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    n_patches=256,
    vision_dim=1024,
    dtype="bfloat16",
)

SMOKE = FULL.replace(
    name="internvl2-smoke",
    n_layers=2,
    d_model=256,
    vocab=512,
    n_heads=4,
    n_kv_heads=2,
    head_dim=64,
    d_ff=512,
    n_patches=16,
    vision_dim=64,
    dtype="float32",
)
