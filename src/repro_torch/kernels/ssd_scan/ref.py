"""Plain PyTorch versions of the SSD intra-chunk contraction (same math as
``src/repro/kernels/ssd_scan/ref.py``) and of the token-by-token recurrence
the tests hold the whole chunked layer against."""
from __future__ import annotations

import torch


def ssd_intra_chunk_ref(xc, dtc, cum, bc, cc, rep: int):
    """xc [B,Nc,L,H,P], dtc/cum [B,Nc,L,H] f32, bc/cc [B,Nc,L,G,N] ->
    (y [B,Nc,L,H,P] in xc's type, state [B,Nc,H,P,N] f32)."""
    l = xc.shape[2]
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B,Nc,L(i),L(j),H]
    causal = torch.tril(torch.ones((l, l), dtype=torch.bool, device=xc.device))
    lmat = torch.where(causal[None, None, :, :, None], torch.exp(seg), 0.0)
    bh = bc.repeat_interleave(rep, dim=3)
    ch = cc.repeat_interleave(rep, dim=3)
    scores = torch.einsum("bnlhs,bnmhs->bnlmh", ch, bh)
    w = scores * lmat * dtc[:, :, None, :, :]
    y = torch.einsum("bnlmh,bnmhp->bnlhp", w.to(xc.dtype), xc)
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)
    wstate = (decay_to_end * dtc)[..., None] * bh
    state = torch.einsum("bnlhs,bnlhp->bnhps", wstate.to(xc.dtype), xc)
    return y, state.float()


def ssd_sequential_ref(x, dt, a, b_, c_, rep: int):
    """x [B,S,H,P], dt [B,S,H], a [H], b_/c_ [B,S,G,N] -> y [B,S,H,P] (f32)."""
    bsz, s, h, p = x.shape
    n = b_.shape[-1]
    bh = b_.repeat_interleave(rep, dim=2)
    ch = c_.repeat_interleave(rep, dim=2)
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        da = torch.exp(dt[:, t] * a[None])
        contrib = (dt[:, t][..., None, None] * x[:, t][..., None]) * bh[:, t][:, :, None, :]
        state = state * da[..., None, None] + contrib
        ys.append(torch.einsum("bhpn,bhn->bhp", state, ch[:, t]))
    return torch.stack(ys, dim=1)
