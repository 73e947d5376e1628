"""CUDA PME average: `ops.pme_average` (wrapper), `kernel.pme_average_cuda`
(launcher), `ref.pme_average_ref` (plain version)."""
