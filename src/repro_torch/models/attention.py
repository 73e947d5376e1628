"""Grouped-query attention, full-sequence path (port of the GQA part of
`repro.models.attention`).

Layout [B, S, H, hd] as in JAX.  The plain grouped attention is written
with `torch.einsum`, as the JAX package leaves it to XLA.  The flash
attention kernel, KV caches, query chunking and MLA come later.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, dense_init, linear, rms_norm, rope_freqs

__all__ = ["gqa_init", "gqa_apply"]

NEG_INF = -1e30


def gqa_init(generator: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(generator, (d, h * hd), dtype),
        "wk": dense_init(generator, (d, kv * hd), dtype),
        "wv": dense_init(generator, (d, kv * hd), dtype),
        "wo": dense_init(generator, (h * hd, d), dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=generator.device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=generator.device)
    return p


def _qkv(params: dict, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = linear(x, params["wq"]).reshape(b, s, h, hd)
    k = linear(x, params["wk"]).reshape(b, s, kv, hd)
    v = linear(x, params["wv"]).reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    cos, sin = rope_freqs(positions, hd, cfg.rope_theta)  # [s, hd/2]
    q = apply_rope(q, cos[None], sin[None])
    k = apply_rope(k, cos[None], sin[None])
    return q, k, v


def _grouped_attention(q, k, v, mask: torch.Tensor, scale: float) -> torch.Tensor:
    """q [B, S, H, hd], k/v [B, T, KV, hd], mask [S, T] (True = attend)."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, s, kv, h // kv, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k).float() * scale
    scores = torch.where(mask[None, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    return out.reshape(b, s, h, hd)


def _causal_mask(s: int, window: Optional[int], device) -> torch.Tensor:
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(s, device=device)[None, :]
    mask = j <= i
    if window is not None:
        mask &= (i - j) < window
    return mask


def gqa_apply(
    params: dict,
    cfg: ModelConfig,
    x: torch.Tensor,          # [B, S, d]
    positions: torch.Tensor,  # [S]
) -> torch.Tensor:
    """Full-sequence causal attention (train)."""
    if cfg.use_flash:
        raise NotImplementedError("flash_attention not yet ported to repro_torch")
    b, s, _ = x.shape
    if cfg.prefill_chunk and s > cfg.prefill_chunk and s % cfg.prefill_chunk == 0:
        raise NotImplementedError("chunked prefill attention not yet ported to repro_torch")
    q, k, v = _qkv(params, cfg, x, positions)
    out = _grouped_attention(q, k, v, _causal_mask(s, cfg.window, x.device),
                             cfg.head_dim ** -0.5)
    return linear(out.reshape(b, s, -1), params["wo"])
