"""Grouped-query attention (port of the GQA part of `repro.models.attention`).

Two execution modes, as in JAX:
  * full sequence (train / prefill): causal, optionally windowed mask, or
    the flash attention kernel when ``cfg.use_flash``;
  * single-token decode against a ring-buffer KV cache of capacity C.

Layout [B, S, H, hd] as in JAX.  The cache stores an explicit
``positions [C]`` array (-1 = empty), so ring wraparound and window masking
fall out of one predicate.  The plain grouped attention is written with
`torch.einsum`, as the JAX package leaves it to XLA.  Query chunking
(``prefill_chunk``) and MLA come later.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, dense_init, linear, rms_norm, rope_freqs

__all__ = ["KVCache", "gqa_init", "gqa_apply", "gqa_decode", "init_kv_cache"]

NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor          # [B, C, KV, hd]
    v: torch.Tensor          # [B, C, KV, hd]
    positions: torch.Tensor  # [C] int32, -1 = empty


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
    """q [B, S, H, hd], k/v [B, T, KV, hd], mask [S, T] or [B, S, T]
    (True = attend)."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, s, kv, h // kv, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k).float() * scale
    mask_b = mask[None, None, None] if mask.dim() == 2 else mask[:, None, None]
    scores = torch.where(mask_b, scores, NEG_INF)
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
    return_cache: bool = False,
    cache_capacity: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Full-sequence causal attention (train / prefill).  With
    `return_cache`, also the KV cache of capacity `cache_capacity` (default
    S) holding the last min(S, capacity) positions."""
    b, s, _ = x.shape
    q, k, v = _qkv(params, cfg, x, positions)
    if cfg.use_flash:
        out = flash_ops.flash_attention(q, k, v, window=cfg.window)
    elif cfg.prefill_chunk and s > cfg.prefill_chunk and s % cfg.prefill_chunk == 0:
        raise NotImplementedError("chunked prefill attention not yet ported to repro_torch")
    else:
        out = _grouped_attention(q, k, v, _causal_mask(s, cfg.window, x.device),
                                 cfg.head_dim ** -0.5)
    y = linear(out.reshape(b, s, -1), params["wo"])
    cache = None
    if return_cache:
        cap = cache_capacity or s
        take = min(s, cap)
        ck = torch.zeros((b, cap) + tuple(k.shape[2:]), dtype=k.dtype, device=k.device)
        cv = torch.zeros((b, cap) + tuple(v.shape[2:]), dtype=v.dtype, device=v.device)
        pos = torch.full((cap,), -1, dtype=torch.int32, device=x.device)
        ck[:, :take] = k[:, -take:]
        cv[:, :take] = v[:, -take:]
        pos[:take] = positions[-take:].to(torch.int32)
        cache = KVCache(ck, cv, pos)
    return y, cache


def gqa_decode(
    params: dict,
    cfg: ModelConfig,
    x: torch.Tensor,  # [B, 1, d]
    pos: int,         # position of the new token
    cache: KVCache,
) -> Tuple[torch.Tensor, KVCache]:
    """One token against the ring-buffer cache.  Writes the new key, value
    and position into `cache` in place (slot pos % C) and returns it."""
    b = x.shape[0]
    cap = cache.k.shape[1]
    q, k, v = _qkv(params, cfg, x, torch.tensor([pos], device=x.device))
    slot = pos % cap
    cache.k[:, slot] = k[:, 0]
    cache.v[:, slot] = v[:, 0]
    cache.positions[slot] = pos
    valid = (cache.positions >= 0) & (cache.positions <= pos)
    if cfg.window is not None:
        valid &= (pos - cache.positions) < cfg.window
    out = _grouped_attention(q, cache.k, cache.v, valid[None, None, :].expand(b, 1, cap),
                             cfg.head_dim ** -0.5)
    y = linear(out.reshape(b, 1, -1), params["wo"])
    return y, cache


def init_kv_cache(cfg: ModelConfig, batch: int, capacity: int, dtype, device) -> KVCache:
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    return KVCache(
        k=torch.zeros((batch, capacity, kv, hd), dtype=dtype, device=device),
        v=torch.zeros((batch, capacity, kv, hd), dtype=dtype, device=device),
        positions=torch.full((capacity,), -1, dtype=torch.int32, device=device),
    )
