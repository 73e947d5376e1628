"""Public flash-attention wrapper: the device of the tensors decides.

CPU tensors take the plain version (`ref.attention_ref`); CUDA tensors
launch the kernel or raise (inside the dry run's memory trace,
`repro_torch.kernels.fake_route`, fake tensors take the kernel's route).
There is no fallback from the card to the plain version, and no gradient: like the JAX package's Pallas kernel, the
kernel is forward only, so the wrapper refuses inputs that require grad.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import fake_route, refuse_grad
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_ref


def flash_attention(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, S, KV, D]
    v: torch.Tensor,  # [B, S, KV, D]
    window: Optional[int] = None,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Causal GQA attention in the JAX layout.  The blocks only decide which
    sequence lengths are accepted, as in ``src/repro/kernels/flash_attention``."""
    s = q.shape[1]
    bq, bk = min(block_q, s), min(block_k, s)
    if s % bq or s % bk:
        raise ValueError(f"seq {s} must be divisible by blocks ({bq},{bk})")
    refuse_grad("flash_attention", q, k, v)
    if not q.is_cuda and not fake_route.active():
        return attention_ref(q, k, v, window)
    return flash_attention_cuda(q, k, v, window)
