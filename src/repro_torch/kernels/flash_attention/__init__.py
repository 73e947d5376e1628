"""CUDA flash attention: `ops.flash_attention` (wrapper),
`kernel.flash_attention_cuda` (launcher), `ref.attention_ref` (plain version)."""
