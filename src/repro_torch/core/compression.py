"""Compression operators of the baseline algorithms (port of
`repro.core.compression`).

Each operator maps a [rows, n] tensor to its compressed-then-decompressed
form, one message per row (the simulation works on dense vectors), and
reports the wire cost of an n-coordinate message in bits, consistently
with PaME's Eq. (8).

``apply(x, u=None, generator=None)``: the randomized operators draw their
uniforms from `generator`, or take them as `u` (x's shape), which is how
the parity tests feed them the JAX package's draws.  `rand_k` keeps the s
coordinates of a row with the smallest uniforms, as JAX's
``argsort(argsort(u)) < s`` does, but finds them one row at a time from
the s-th smallest value (`torch.topk`): a double argsort of a
276.8 M-coordinate row would take 8.9 GB of int64 a pass.  Values equal
to the threshold are taken in index order, as JAX's stable argsort ranks
them; ties are common, since f32 uniforms carry only 23 random bits.
`top_k` ranks |x| the same way.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

__all__ = ["Compressor", "identity", "rand_k", "top_k", "qsgd", "one_bit"]


@dataclasses.dataclass(frozen=True)
class Compressor:
    name: str
    # (x [rows, n], u=None, generator=None) -> decompressed x_hat
    apply: Callable[..., torch.Tensor]
    # n -> bits on the wire per message
    bits: Callable[[int], int]


def _keep(frac: float, n: int) -> int:
    return max(1, int(round(frac * n)))


def _uniforms(x: torch.Tensor, u, generator, dtype=torch.float32) -> torch.Tensor:
    if u is not None:
        return u.to(x.device).reshape(x.shape)
    return torch.rand(x.shape, generator=generator, device=x.device, dtype=dtype)


def _first_s(row: torch.Tensor, s: int) -> torch.Tensor:
    """Bool mask of the s smallest entries of a 1-D `row`, equal values
    ranked by index (a stable argsort's ranks < s)."""
    thr = torch.topk(row, s, largest=False, sorted=False).values.max()
    mask = row < thr
    need = s - int(mask.sum())
    mask[torch.nonzero(row == thr).flatten()[:need]] = True
    return mask


def _keep_rows(x: torch.Tensor, scores: torch.Tensor, s: int,
               scale: Optional[float] = None) -> torch.Tensor:
    """x with all but the s coordinates of each row with the smallest
    `scores` set to 0 (kept values times `scale` when given)."""
    out = torch.zeros_like(x)
    for r in range(x.shape[0]):
        keep = _first_s(scores[r], s)
        out[r] = torch.where(keep, x[r] if scale is None else x[r] * scale, out[r])
    return out


def identity() -> Compressor:
    return Compressor("identity", lambda x, u=None, generator=None: x, lambda n: 64 * n)


def rand_k(frac: float, value_bits: int = 64, rescale: bool = True) -> Compressor:
    """rand-k sparsifier.  rescale=True gives the *unbiased* operator
    (E C(x) = x); rescale=False the *contractive* one
    (||C(x) − x||² ≤ (1 − s/n)||x||²) that CHOCO-SGD and BEER need."""

    def apply(x, u=None, generator=None):
        n = x.shape[-1]
        s = _keep(frac, n)
        return _keep_rows(x, _uniforms(x, u, generator), s,
                          scale=n / s if rescale else None)

    def bits(n: int) -> int:
        return (value_bits - 1) * _keep(frac, n) + n

    return Compressor(f"rand{frac:g}", apply, bits)


def top_k(frac: float, value_bits: int = 64) -> Compressor:
    def apply(x, u=None, generator=None):
        return _keep_rows(x, -x.abs(), _keep(frac, x.shape[-1]))

    def bits(n: int) -> int:
        return (value_bits - 1) * _keep(frac, n) + n

    return Compressor(f"top{frac:g}", apply, bits)


def qsgd(levels: int = 16) -> Compressor:
    """QSGD stochastic quantization to `levels` levels per sign.  The
    uniforms are drawn in x's type, as `jax.random.bernoulli` draws them in
    the type of its probability."""

    def apply(x, u=None, generator=None):
        norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-12)
        y = x.abs() / norm * levels
        lo = torch.floor(y)
        bump = _uniforms(x, u, generator, dtype=x.dtype) < (y - lo)
        q = (lo + bump) / levels
        return torch.sign(x) * q * norm

    per_coord = 1 + math.ceil(math.log2(levels + 1))
    return Compressor(f"qsgd{levels}", apply, lambda n: 32 + per_coord * n)


def one_bit() -> Compressor:
    """Sign compression with per-message scale (1-bit SGD style)."""

    def apply(x, u=None, generator=None):
        return torch.sign(x) * x.abs().mean(dim=-1, keepdim=True)

    return Compressor("onebit", apply, lambda n: 32 + n)
