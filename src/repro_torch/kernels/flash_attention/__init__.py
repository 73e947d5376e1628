"""CUDA flash attention: `ops.flash_attention` (wrapper),
`kernel.flash_attention_cuda` (launcher), `ref.attention_ref` (plain version)."""
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: F401
