"""Plain PyTorch version of the PME average kernel (same math as
``src/repro/kernels/pme_average/ref.py``): f32 compute, output in w's type.
With a lane axis ([L, m, n] operands, [L, m, m] selections) it is a loop
of the single-lane version over the lanes."""
from __future__ import annotations

import torch


def pme_average_ref(w: torch.Tensor, masks: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    if w.dim() == 3:
        return torch.stack([pme_average_ref(w_l, m_l, a_l) for w_l, m_l, a_l in zip(w, masks, a)])
    maskf = masks.float()
    wf = w.float()
    af = a.float()
    agg = torch.einsum("jn,ji->in", wf * maskf, af)
    cnt = torch.einsum("jn,ji->in", maskf, af)
    out = torch.where(cnt > 0, agg / torch.clamp(cnt, min=1.0), wf)
    return out.to(w.dtype)
