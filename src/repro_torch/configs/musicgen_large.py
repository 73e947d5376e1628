"""musicgen-large [audio] — decoder-only over EnCodec tokens [arXiv:2306.05284].

48L d_model=2048 32H (kv=32, head_dim=64) d_ff=8192 vocab=2048.
The EnCodec conv codec frontend is STUBBED per spec: inputs are already
token ids in the 2048-entry codec vocabulary (codebook-interleaved stream).
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="musicgen-large",
    arch_type="audio",
    n_layers=48,
    d_model=2048,
    vocab=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    dtype="bfloat16",
)

SMOKE = FULL.replace(
    name="musicgen-smoke",
    n_layers=2,
    d_model=256,
    vocab=512,
    n_heads=4,
    n_kv_heads=4,
    head_dim=64,
    d_ff=512,
    dtype="float32",
)
