"""Plain PyTorch version of the PME average kernel (same math as
``src/repro/kernels/pme_average/ref.py``): f32 compute, output in w's type.
With a lane axis ([L, m, n] operands, [L, m, m] selections) it is a loop
of the single-lane version over the lanes.  ``receivers=(r0, r)`` is the
kernel's receiver range: every row sends, receivers r0 ... r0 + r - 1
take the selection's columns A[:, r0:r0 + r] and their own rows as the
lambda = 0 fill, and the output is [r, n].  It is the square form's
contraction over those columns, so it gives the square form's rows
r0 ... r0 + r - 1 as far as the matrix product rounds a column the same
with or without the others (bit for bit at m = 4 on the CPU, which
`tests/test_torch_kernels.py` checks; a BLAS may take a matrix-vector
routine for a single column, which sums in another order at larger m).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def pme_average_ref(w: torch.Tensor, masks: torch.Tensor, a: torch.Tensor,
                    receivers: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    if w.dim() == 3:
        return torch.stack([pme_average_ref(w_l, m_l, a_l, receivers)
                            for w_l, m_l, a_l in zip(w, masks, a)])
    rows = slice(None) if receivers is None else slice(receivers[0], receivers[0] + receivers[1])
    maskf = masks.float()
    wf = w.float()
    af = a.float()[:, rows]
    agg = torch.einsum("jn,ji->in", wf * maskf, af)
    cnt = torch.einsum("jn,ji->in", maskf, af)
    out = torch.where(cnt > 0, agg / torch.clamp(cnt, min=1.0), wf[rows])
    return out.to(w.dtype)
