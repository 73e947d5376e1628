"""Shared primitives: norms, rope, initializers, projections (port of
`repro.models.layers`).  Linear weights are [d_in, d_out], as in JAX.

The tensor-parallel forms act on a rank's pieces under a
`repro_torch.sharding.Serve` view (``sv``; unsharded, every piece whole and
each of them the plain form): a column-parallel product is `linear` on the
rank's columns (`Serve.part`); `row_linear` multiplies the rank's rows of
a weight and sums the partial outputs over `model`; `vocab_embed` and
`vocab_logits` are the embedding's lookup and the output projection on the
rank's slice of the vocabulary.  In training (a `sharding.train_view`) a
whole input entering the rank's part of a product goes through
`Serve.enter`, so that its gradient is summed over `model`."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["rms_norm", "dense_init", "embed_init", "rope_freqs", "apply_rope", "linear",
           "row_linear", "vocab_embed", "vocab_logits"]


# rows a norm takes at a time outside autograd: its f32 temporaries are then
# bounded (at 524,288 tokens a whole [S, 4096] activation is 8.6 GB in f32)
_NORM_ROWS = 1 << 15


def _rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the last dim in f32, cast back to x's type.  Without
    autograd, inputs of more than _NORM_ROWS rows are normed that many rows
    at a time into one output (the same numbers: each row is normed alone)."""
    rows = x.numel() // max(x.shape[-1], 1)
    if rows <= _NORM_ROWS or torch.is_grad_enabled():
        return _rms_norm(x, scale, eps)
    flat = x.reshape(rows, x.shape[-1])
    out = torch.empty_like(flat)
    for lo in range(0, rows, _NORM_ROWS):
        out[lo:lo + _NORM_ROWS] = _rms_norm(flat[lo:lo + _NORM_ROWS], scale, eps)
    return out.view(x.shape)


def dense_init(generator: torch.Generator, shape: Tuple[int, ...], dtype,
               fan_in: Optional[int] = None) -> torch.Tensor:
    x = torch.randn(shape, generator=generator, device=generator.device)
    return (x * (fan_in if fan_in is not None else shape[0]) ** -0.5).to(dtype)


def embed_init(generator: torch.Generator, vocab: int, d: int, dtype) -> torch.Tensor:
    x = torch.randn((vocab, d), generator=generator, device=generator.device)
    return (x * 0.02).to(dtype)


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, w)


def row_linear(x: torch.Tensor, w: torch.Tensor, sv, k: int, x_lo: int = 0) -> torch.Tensor:
    """x @ W for a weight W [k, n] whose rows may be split over `model`:
    `w` is this rank's piece of W, `x` [..., j] holds the input's columns
    x_lo ... x_lo + j - 1 (all k when it is whole).  A whole W takes the
    whole input; a piece takes the input's matching columns (a whole input,
    which every model rank holds, through `Serve.enter`), and the partial
    products are summed over `model` in their own type
    (``use="activations"``), as XLA's partitioned dot does."""
    if w.shape[0] == k:
        if x.shape[-1] != k:
            raise ValueError(f"a whole [{k}, n] weight needs the whole input, got "
                             f"{x.shape[-1]} columns")
        return linear(x, w)
    lo, hi = sv.span(w, 0, k)
    if lo < x_lo or hi > x_lo + x.shape[-1]:
        raise ValueError(f"the input's columns [{x_lo}, {x_lo + x.shape[-1]}) do not hold "
                         f"the weight's rows [{lo}, {hi})")
    if (lo, hi) != (x_lo, x_lo + x.shape[-1]):
        x = sv.enter(x).narrow(-1, lo - x_lo, hi - lo)
    return sv.psum(linear(x, w))


def vocab_embed(table: torch.Tensor, tokens: torch.Tensor, sv, vocab: int) -> torch.Tensor:
    """``table[tokens]`` for an embedding [vocab, d] whose rows may be split
    over `model`: a rank's slice gives its own tokens' rows and zeros
    elsewhere, summed over `model` (``use="embed"``; a sum of one row and
    zeros, exact in any type)."""
    tokens = tokens.long()
    if table.shape[0] == vocab:
        return table[tokens]
    lo, hi = sv.span(table, 0, vocab)
    local = tokens - lo
    inside = (local >= 0) & (local < hi - lo)
    x = torch.where(inside[..., None], table[local.clamp(0, hi - lo - 1)],
                    torch.zeros((), dtype=table.dtype, device=table.device))
    return sv.psum(x, "embed")


def vocab_logits(x: torch.Tensor, head: torch.Tensor, sv, vocab: int) -> torch.Tensor:
    """``x @ head`` in f32 for an output projection [d, vocab] whose
    columns may be split over `model`: each rank's slice of the logits,
    gathered over `model` into the whole vocabulary (``use="logits"``)."""
    if head.shape[1] == vocab:
        return torch.matmul(x, head).float()
    return sv.cat(torch.matmul(sv.enter(x), head).float(), -1, "logits")


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
