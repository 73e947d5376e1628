"""CUDA gossip contraction: `ops.gather_terms_kernel` (wrapper),
`kernel.gossip_gather` (launcher), `ref.gather_terms_ref` (plain version)."""
from repro_torch.kernels.gossip.ref import gather_terms_ref  # noqa: F401
