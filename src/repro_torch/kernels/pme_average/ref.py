"""Plain PyTorch version of the PME average kernel (same math as
``src/repro/kernels/pme_average/ref.py``): f32 compute, output in w's type."""
from __future__ import annotations

import torch


def pme_average_ref(w: torch.Tensor, masks: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    maskf = masks.float()
    wf = w.float()
    af = a.float()
    agg = torch.einsum("jn,ji->in", wf * maskf, af)
    cnt = torch.einsum("jn,ji->in", maskf, af)
    out = torch.where(cnt > 0, agg / torch.clamp(cnt, min=1.0), wf)
    return out.to(w.dtype)
