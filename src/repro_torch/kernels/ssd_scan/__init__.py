"""CUDA SSD intra-chunk contraction: `ops.ssd_intra_chunk` (wrapper),
`kernel.ssd_intra_chunk_cuda` (launcher), `ref.ssd_intra_chunk_ref` (plain
version) and `ref.ssd_sequential_ref` (the per-token recurrence)."""
from repro_torch.kernels.ssd_scan.ops import ssd_intra_chunk  # noqa: F401
