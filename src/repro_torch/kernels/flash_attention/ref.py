"""Plain PyTorch version of the flash attention kernel (same math as
``src/repro/kernels/flash_attention/ref.py``): materialised scores, f32
softmax, causal (optionally windowed) mask."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, S, KV, D]
    v: torch.Tensor,  # [B, S, KV, D]
    window: Optional[int] = None,
) -> torch.Tensor:
    b, s, h, d = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, d)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k).float() * d ** -0.5
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(s, device=q.device)[None, :]
    mask = j <= i
    if window is not None:
        mask &= (i - j) < window
    scores = torch.where(mask[None, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs.to(v.dtype), v)
    return out.reshape(b, s, h, d)
