"""Plain PyTorch version of the gossip kernel: the dense scatter-matrix
contraction of ``src/repro/kernels/gossip/ref.py``.

Builds S[i, j] = sum_{slot: nbrs[i, slot] = j} w[i, slot] (padding slots
zeroed first) and contracts it with one f32 matmul per term.  O(m^2)
memory: a test oracle and the kernel's yardstick on the card, not a
production path.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def gather_terms_ref(
    nbrs: torch.Tensor,                                   # [m, k] padded table
    terms: Sequence[Tuple[torch.Tensor, torch.Tensor]],   # ([m, k] w, [m, ...] x)
    *,
    pad: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    m = nbrs.shape[0]
    rows = torch.arange(m, device=nbrs.device)[:, None].expand_as(nbrs)
    idx = nbrs.long()
    outs = []
    for w, x in terms:
        wf = w.float()
        if pad is not None:
            wf = torch.where(pad, torch.zeros_like(wf), wf)
        s = torch.zeros((m, m), dtype=torch.float32, device=nbrs.device)
        s.index_put_((rows, idx), wf, accumulate=True)
        x2 = x.reshape(m, -1).float()
        outs.append((s @ x2).reshape(x.shape).to(x.dtype))
    return tuple(outs)
