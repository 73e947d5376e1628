"""Public wrapper of the PME average: the device of the tensors decides.

CPU tensors take the plain version (`ref.pme_average_ref`, with the mask
cast to w's type as ``src/repro/kernels/pme_average/ops.py`` does); CUDA
tensors launch the kernel or raise.  There is no fallback from the card to
the plain version.  Inside the dry run's memory trace
(`repro_torch.kernels.fake_route`) the kernel's route is taken on fake
tensors whatever their device.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import fake_route
from repro_torch.kernels.pme_average.kernel import pme_average_cuda
from repro_torch.kernels.pme_average.ref import pme_average_ref


def pme_average(w: torch.Tensor, masks: torch.Tensor, a: torch.Tensor,
                receivers: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Count-weighted PME average; masks may be bool or numeric.  One lane
    ([m, n], [m, m]) or L lanes ([L, m, n], [L, m, m]); ``receivers=(r0,
    r)`` gives receivers r0 ... r0 + r - 1 only ([r, n])."""
    if not w.is_cuda and not fake_route.active():
        return pme_average_ref(w, masks.to(w.dtype), a, receivers)
    return pme_average_cuda(w, masks, a, receivers)
