"""Public wrapper of the PME average: the device of the tensors decides.

CPU tensors take the plain version (`ref.pme_average_ref`, with the mask
cast to w's type as ``src/repro/kernels/pme_average/ops.py`` does); CUDA
tensors launch the kernel or raise.  There is no fallback from the card to
the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.pme_average.kernel import pme_average_cuda
from repro_torch.kernels.pme_average.ref import pme_average_ref


def pme_average(w: torch.Tensor, masks: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Count-weighted PME average; masks may be bool or numeric.  One lane
    ([m, n], [m, m]) or L lanes ([L, m, n], [L, m, m])."""
    if not w.is_cuda:
        return pme_average_ref(w, masks.to(w.dtype), a)
    return pme_average_cuda(w, masks, a)
