"""Shared primitives: norms, rope, initializers, projections (port of
`repro.models.layers`).  Linear weights are [d_in, d_out], as in JAX."""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["rms_norm", "dense_init", "embed_init", "rope_freqs", "apply_rope", "linear"]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def dense_init(generator: torch.Generator, shape: Tuple[int, ...], dtype) -> torch.Tensor:
    x = torch.randn(shape, generator=generator, device=generator.device)
    return (x * shape[0] ** -0.5).to(dtype)


def embed_init(generator: torch.Generator, vocab: int, d: int, dtype) -> torch.Tensor:
    x = torch.randn((vocab, d), generator=generator, device=generator.device)
    return (x * 0.02).to(dtype)


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, w)


def rope_freqs(positions: torch.Tensor, dim: int, theta: float):
    """positions [...] int -> (cos, sin) of shape [..., dim/2], f32."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [..., dim]; cos/sin broadcastable to [..., dim/2] (split halves)."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    while cos.dim() < x1.dim():  # broadcast over the head axis
        cos = cos[..., None, :]
        sin = sin[..., None, :]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1, out2], dim=-1).to(x.dtype)
