"""Attention blocks: GQA (optional qk-norm, sliding window) and MLA (port
of `repro.models.attention`).

Two execution modes, as in JAX:
  * full sequence (train / prefill): causal, optionally windowed mask; for
    GQA the flash attention kernel when ``cfg.use_flash``, else query
    chunks of ``cfg.prefill_chunk`` rows when S is a larger multiple of it
    (the score buffer is then [.., chunk, S], not [.., S, S]);
  * single-token decode against a ring-buffer cache of capacity C.

Layout [B, S, H, hd] as in JAX.  A cache stores an explicit ``positions
[C]`` array (-1 = empty), so ring wraparound and window masking fall out
of one predicate.  MLA decodes in the absorbed form: its cache holds only
the compressed c_kv and k_rope streams, and the per-head expansions W_uk
and W_uv fold into the query and the output (DeepSeek-V2, Sec. 2.1).  The
plain attention is written with `torch.einsum`, as the JAX package leaves
it to XLA.

Sharded serving (a `repro_torch.sharding.Serve` view ``sv``; unsharded, the
view of one rank and every piece whole): each rank computes its H / t
query heads (all H, replicated, where t does not divide H) and the K / V
heads they read: its KV / t where t divides KV, else every K / V head
computed replicated and its groups selected.  ``wq`` / ``wk`` / ``wv``
(MLA: ``w_uq`` / ``w_uk`` / ``w_uv``) are column-parallel on those heads,
gathered over `model` where their pieces are cut inside a head;
``wo`` is row-parallel, its partial outputs summed over `model`.  A rank's
new K / V rows are gathered over `model` into its whole cache
(``use="cache"``), and attention reads the rank's own heads from it.  MLA's
``w_dq`` and ``w_dkv`` and its latent cache are whole on every rank.

In training (a `sharding.train_view`, full sequence only), every tensor
that all model ranks hold whole and that the rank's heads read goes
through `Serve.enter` (its gradient summed over `model`): the block's
input where its heads' projections are split, ``q_norm`` / ``k_norm`` on
split heads, K / V computed for all KV heads and read by a rank's query
heads, and MLA's query latent, ``c_kv`` and ``k_rope``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch import sharding as shd
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_rope, dense_init, linear, rms_norm, rope_freqs,
                                      row_linear)

__all__ = ["KVCache", "MLACache", "gqa_init", "gqa_apply", "gqa_decode", "mla_init",
           "mla_apply", "mla_decode", "init_kv_cache", "init_mla_cache", "mask_is_plain"]

NEG_INF = -1e30
_UNSHARDED = shd.serve_view(None)


class KVCache(NamedTuple):
    k: torch.Tensor          # [B, C, KV, hd]
    v: torch.Tensor          # [B, C, KV, hd]
    positions: torch.Tensor  # [C] int32, -1 = empty


class MLACache(NamedTuple):
    c_kv: torch.Tensor       # [B, C, kv_lora]
    k_rope: torch.Tensor     # [B, C, rope_hd]
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


class _Heads(NamedTuple):
    """A rank's query heads [h_lo, h_hi) and the K / V heads [kv_lo,
    kv_hi) it computes (all KV where t does not divide KV)."""

    h_lo: int
    h_hi: int
    kv_lo: int
    kv_hi: int


def _gqa_heads(cfg: ModelConfig, sv) -> _Heads:
    h_lo, h_hi = sv.heads(cfg.n_heads)
    if (h_lo, h_hi) == (0, cfg.n_heads):
        return _Heads(0, cfg.n_heads, 0, cfg.n_kv_heads)
    return _Heads(h_lo, h_hi, *sv.heads(cfg.n_kv_heads))


def _kv_for(k: torch.Tensor, hs: _Heads, cfg: ModelConfig) -> torch.Tensor:
    """The K / V heads [B, T, *, hd] the rank's query heads read, grouped
    evenly over them (query head j reads K / V head j // (H / KV)): a
    slice of `k` (holding heads kv_lo ... kv_hi - 1), or one K / V head a
    query head where the groups do not fall evenly."""
    g = cfg.n_heads // cfg.n_kv_heads
    lo, hi = hs.h_lo // g, (hs.h_hi - 1) // g + 1
    if (lo, hi) == (hs.kv_lo, hs.kv_hi):
        return k
    n = hs.h_hi - hs.h_lo
    if hi - lo == 1 or (hs.h_lo % g == 0 and n % g == 0):
        return k[:, :, lo - hs.kv_lo: hi - hs.kv_lo]
    idx = torch.arange(hs.h_lo, hs.h_hi, device=k.device) // g - hs.kv_lo
    return k.index_select(2, idx)


def _qkv(params: dict, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor, sv,
         hs: _Heads):
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q_split, kv_split = hs.h_hi - hs.h_lo < h, hs.kv_hi - hs.kv_lo < kv
    xq = sv.enter(x) if q_split else x
    xkv = xq if kv_split else x
    q = linear(xq, sv.part(params["wq"], 1, h * hd, hs.h_lo * hd, hs.h_hi * hd, "attn/wq"))
    k = linear(xkv, sv.part(params["wk"], 1, kv * hd, hs.kv_lo * hd, hs.kv_hi * hd, "attn/wk"))
    v = linear(xkv, sv.part(params["wv"], 1, kv * hd, hs.kv_lo * hd, hs.kv_hi * hd, "attn/wv"))
    q = q.reshape(b, s, hs.h_hi - hs.h_lo, hd)
    k = k.reshape(b, s, hs.kv_hi - hs.kv_lo, hd)
    v = v.reshape(b, s, hs.kv_hi - hs.kv_lo, hd)
    if cfg.qk_norm:
        q = rms_norm(q, sv.enter(params["q_norm"]) if q_split else params["q_norm"])
        k = rms_norm(k, sv.enter(params["k_norm"]) if kv_split else params["k_norm"])
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


def _chunk_mask(rows: torch.Tensor, s: int, window: Optional[int]) -> torch.Tensor:
    """[len(rows), s]: causal (and windowed) mask of query rows `rows`."""
    j = torch.arange(s, device=rows.device)
    mask = j[None, :] <= rows[:, None]
    if window is not None:
        mask &= (rows[:, None] - j[None, :]) < window
    return mask


def _chunked_grouped_attention(q, k, v, window: Optional[int], scale: float,
                               chunk: int) -> torch.Tensor:
    """Causal attention in query chunks of `chunk` rows (S itself: one
    chunk): the score buffer is [.., chunk, S] instead of [.., S, S] (the
    prefill memory cap); the keys stay whole."""
    s = q.shape[1]
    outs = [_grouped_attention(q[:, lo: lo + chunk], k, v,
                               _chunk_mask(torch.arange(lo, lo + chunk, device=q.device), s,
                                           window), scale)
            for lo in range(0, s, chunk)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def _chunked(cfg: ModelConfig, s: int) -> bool:
    """Whether a full-sequence pass of length s runs in query chunks."""
    return bool(cfg.prefill_chunk) and s > cfg.prefill_chunk and s % cfg.prefill_chunk == 0


def _full_cache(cache_cls, streams, positions: torch.Tensor, capacity: Optional[int]):
    """A ring cache of `capacity` (default S) holding the last min(S,
    capacity) positions of each [B, S, ...] stream."""
    b, s = streams[0].shape[:2]
    cap = capacity or s
    take = min(s, cap)
    out = []
    for x in streams:
        buf = torch.zeros((b, cap) + tuple(x.shape[2:]), dtype=x.dtype, device=x.device)
        buf[:, :take] = x[:, -take:]
        out.append(buf)
    pos = torch.full((cap,), -1, dtype=torch.int32, device=positions.device)
    pos[:take] = positions[-take:].to(torch.int32)
    return cache_cls(*out, pos)


def gqa_apply(
    params: dict,
    cfg: ModelConfig,
    x: torch.Tensor,          # [B, S, d]
    positions: torch.Tensor,  # [S]
    return_cache: bool = False,
    cache_capacity: Optional[int] = None,
    sv=None,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Full-sequence causal attention (train / prefill).  With
    `return_cache`, also the KV cache of capacity `cache_capacity` (default
    S) holding the last min(S, capacity) positions (whole over `model`
    under a sharded view `sv`)."""
    b, s, _ = x.shape
    sv = sv or _UNSHARDED
    hs = _gqa_heads(cfg, sv)
    q, k, v = _qkv(params, cfg, x, positions, sv, hs)
    ka, va = k, v
    if hs.h_hi - hs.h_lo < cfg.n_heads and hs.kv_hi - hs.kv_lo == cfg.n_kv_heads:
        ka, va = sv.enter(k), sv.enter(v)  # whole K / V read by the rank's heads
    ka, va = _kv_for(ka, hs, cfg), _kv_for(va, hs, cfg)
    scale = cfg.head_dim ** -0.5
    if cfg.use_flash and mask_is_plain(cfg, s):
        out = flash_ops.flash_attention(q, ka, va, window=cfg.window)
    else:
        out = _chunked_grouped_attention(q, ka, va, cfg.window, scale,
                                         cfg.prefill_chunk if _chunked(cfg, s) else s)
    del ka, va
    hd = cfg.head_dim
    y = row_linear(out.reshape(b, s, -1), params["wo"], sv, cfg.n_heads * hd, hs.h_lo * hd)
    cache = None
    if return_cache:
        k, v = (sv.cat(u, 2, "cache") if u.shape[2] < cfg.n_kv_heads else u for u in (k, v))
        cache = _full_cache(KVCache, (k, v), positions, cache_capacity)
    return y, cache


def mask_is_plain(cfg: ModelConfig, s: int) -> bool:
    """Whether flash can take a prefill of `s` rows: always, the kernel
    handles the causal and window masks itself (as JAX's)."""
    return True


def gqa_decode(
    params: dict,
    cfg: ModelConfig,
    x: torch.Tensor,  # [B, 1, d]
    pos: int,         # position of the new token
    cache: KVCache,
    sv=None,
) -> Tuple[torch.Tensor, KVCache]:
    """One token against the ring-buffer cache.  Writes the new key, value
    and position into `cache` in place (slot pos % C) and returns it; under
    a sharded view `sv` the cache is whole over `model` and the rank's new
    K / V heads are gathered into it."""
    b = x.shape[0]
    cap = cache.k.shape[1]
    sv = sv or _UNSHARDED
    hs = _gqa_heads(cfg, sv)
    q, k, v = _qkv(params, cfg, x, torch.tensor([pos], device=x.device), sv, hs)
    slot = pos % cap
    cache.k[:, slot] = sv.cat(k[:, 0], 1, "cache") if k.shape[2] < cfg.n_kv_heads else k[:, 0]
    cache.v[:, slot] = sv.cat(v[:, 0], 1, "cache") if v.shape[2] < cfg.n_kv_heads else v[:, 0]
    cache.positions[slot] = pos
    valid = (cache.positions >= 0) & (cache.positions <= pos)
    if cfg.window is not None:
        valid &= (pos - cache.positions) < cfg.window
    mine = _Heads(hs.h_lo, hs.h_hi, 0, cfg.n_kv_heads)
    out = _grouped_attention(q, _kv_for(cache.k, mine, cfg), _kv_for(cache.v, mine, cfg),
                             valid[None, None, :].expand(b, 1, cap), cfg.head_dim ** -0.5)
    hd = cfg.head_dim
    y = row_linear(out.reshape(b, 1, -1), params["wo"], sv, cfg.n_heads * hd, hs.h_lo * hd)
    return y, cache


def init_kv_cache(cfg: ModelConfig, batch: int, capacity: int, dtype, device) -> KVCache:
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    return KVCache(
        k=torch.zeros((batch, capacity, kv, hd), dtype=dtype, device=device),
        v=torch.zeros((batch, capacity, kv, hd), dtype=dtype, device=device),
        positions=torch.full((capacity,), -1, dtype=torch.int32, device=device),
    )


def init_mla_cache(cfg: ModelConfig, batch: int, capacity: int, dtype, device) -> MLACache:
    return MLACache(
        c_kv=torch.zeros((batch, capacity, cfg.kv_lora), dtype=dtype, device=device),
        k_rope=torch.zeros((batch, capacity, cfg.rope_head_dim), dtype=dtype, device=device),
        positions=torch.full((capacity,), -1, dtype=torch.int32, device=device),
    )


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------
def mla_init(generator: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    nope, rope_hd, v_hd = cfg.head_dim, cfg.rope_head_dim, cfg.v_head_dim
    dev = generator.device
    p = {}
    if cfg.q_lora:  # the query's low-rank path (deepseek-v2-236b)
        p["w_dq"] = dense_init(generator, (d, cfg.q_lora), dtype)
        p["q_norm"] = torch.ones((cfg.q_lora,), dtype=dtype, device=dev)
    p.update({
        "w_uq": dense_init(generator, (cfg.q_lora or d, h * (nope + rope_hd)), dtype),
        "w_dkv": dense_init(generator, (d, cfg.kv_lora + rope_hd), dtype),
        "kv_norm": torch.ones((cfg.kv_lora,), dtype=dtype, device=dev),
        "w_uk": dense_init(generator, (cfg.kv_lora, h * nope), dtype),
        "w_uv": dense_init(generator, (cfg.kv_lora, h * v_hd), dtype),
        "wo": dense_init(generator, (h * v_hd, d), dtype),
    })
    return p


def _mla_q(params: dict, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor, sv,
           h_lo: int, h_hi: int):
    b, s, _ = x.shape
    h, nope, rope_hd = cfg.n_heads, cfg.head_dim, cfg.rope_head_dim
    cq = rms_norm(linear(x, params["w_dq"]), params["q_norm"]) if cfg.q_lora else x
    cq = cq if h_hi - h_lo == h else sv.enter(cq)
    w = nope + rope_hd
    q = linear(cq, sv.part(params["w_uq"], 1, h * w, h_lo * w, h_hi * w, "attn/w_uq"))
    q = q.reshape(b, s, h_hi - h_lo, w)
    cos, sin = rope_freqs(positions, rope_hd, cfg.rope_theta)
    return q[..., :nope], apply_rope(q[..., nope:], cos[None], sin[None])


def _mla_ckv(params: dict, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    ckv_full = linear(x, params["w_dkv"])
    c_kv = rms_norm(ckv_full[..., :cfg.kv_lora], params["kv_norm"])
    cos, sin = rope_freqs(positions, cfg.rope_head_dim, cfg.rope_theta)
    return c_kv, apply_rope(ckv_full[..., cfg.kv_lora:], cos[None], sin[None])


def mla_apply(
    params: dict,
    cfg: ModelConfig,
    x: torch.Tensor,          # [B, S, d]
    positions: torch.Tensor,  # [S]
    return_cache: bool = False,
    cache_capacity: Optional[int] = None,
    sv=None,
) -> Tuple[torch.Tensor, Optional[MLACache]]:
    """Full-sequence MLA with the per-head expansion (train / prefill), in
    query chunks of ``cfg.prefill_chunk`` as GQA chunks them; under a
    sharded view `sv`, on the rank's heads."""
    b, s, _ = x.shape
    sv = sv or _UNSHARDED
    h, nope, v_hd = cfg.n_heads, cfg.head_dim, cfg.v_head_dim
    h_lo, h_hi = sv.heads(h)
    q_nope, q_rope = _mla_q(params, cfg, x, positions, sv, h_lo, h_hi)
    c_kv, k_rope = _mla_ckv(params, cfg, x, positions)
    if h_hi - h_lo < h:  # the latents every rank holds whole, read by its heads
        c_kv, k_rope = sv.enter(c_kv), sv.enter(k_rope)
    k_nope = linear(c_kv, sv.part(params["w_uk"], 1, h * nope, h_lo * nope, h_hi * nope,
                                  "attn/w_uk")).reshape(b, s, h_hi - h_lo, nope)
    v = linear(c_kv, sv.part(params["w_uv"], 1, h * v_hd, h_lo * v_hd, h_hi * v_hd,
                             "attn/w_uv")).reshape(b, s, h_hi - h_lo, v_hd)
    scale = (nope + cfg.rope_head_dim) ** -0.5

    def attend(qn, qr, rows):  # qn [B, C, H, nope], rows [C]
        sc = (torch.einsum("bshn,bthn->bhst", qn, k_nope)
              + torch.einsum("bshr,btr->bhst", qr, k_rope)).float() * scale
        sc = torch.where(_chunk_mask(rows, s, cfg.window)[None, None], sc, NEG_INF)
        probs = torch.softmax(sc, dim=-1).to(v.dtype)
        return torch.einsum("bhst,bthv->bshv", probs, v)

    chunk = cfg.prefill_chunk if _chunked(cfg, s) else s
    outs = [attend(q_nope[:, lo: lo + chunk], q_rope[:, lo: lo + chunk],
                   torch.arange(lo, lo + chunk, device=x.device))
            for lo in range(0, s, chunk)]
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    y = row_linear(out.reshape(b, s, -1), params["wo"], sv, h * v_hd, h_lo * v_hd)
    cache = (_full_cache(MLACache, (c_kv, k_rope), positions, cache_capacity)
             if return_cache else None)
    return y, cache


def mla_decode(
    params: dict,
    cfg: ModelConfig,
    x: torch.Tensor,  # [B, 1, d]
    pos: int,         # position of the new token
    cache: MLACache,
    sv=None,
) -> Tuple[torch.Tensor, MLACache]:
    """Absorbed-form decode: scores against the compressed cache.  Writes
    the new c_kv, k_rope and position into `cache` in place (slot pos % C)
    and returns it; under a sharded view `sv`, on the rank's heads (the
    latent cache is whole on every rank)."""
    b = x.shape[0]
    sv = sv or _UNSHARDED
    h, nope, v_hd = cfg.n_heads, cfg.head_dim, cfg.v_head_dim
    h_lo, h_hi = sv.heads(h)
    hn = h_hi - h_lo
    cap = cache.c_kv.shape[1]
    p = torch.tensor([pos], device=x.device)
    q_nope, q_rope = _mla_q(params, cfg, x, p, sv, h_lo, h_hi)  # [B, 1, H, *]
    c_new, kr_new = _mla_ckv(params, cfg, x, p)
    slot = pos % cap
    cache.c_kv[:, slot] = c_new[:, 0]
    cache.k_rope[:, slot] = kr_new[:, 0]
    cache.positions[slot] = pos
    valid = (cache.positions >= 0) & (cache.positions <= pos)
    if cfg.window is not None:
        valid &= (pos - cache.positions) < cfg.window
    # absorb W_uk into the query: q_eff[b, h, c] = q_nope . W_uk[c, h, :]
    w_uk = sv.part(params["w_uk"], 1, h * nope, h_lo * nope, h_hi * nope,
                   "attn/w_uk").reshape(cfg.kv_lora, hn, nope)
    q_eff = torch.einsum("bshn,chn->bshc", q_nope, w_uk)[:, 0]  # [B, H, kv_lora]
    scale = (nope + cfg.rope_head_dim) ** -0.5
    scores = (torch.einsum("bhc,btc->bht", q_eff, cache.c_kv)
              + torch.einsum("bshr,btr->bht", q_rope, cache.k_rope)).float() * scale
    scores = torch.where(valid[None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(cache.c_kv.dtype)
    ctx = torch.einsum("bht,btc->bhc", probs, cache.c_kv)  # the compressed context
    w_uv = sv.part(params["w_uv"], 1, h * v_hd, h_lo * v_hd, h_hi * v_hd,
                   "attn/w_uv").reshape(cfg.kv_lora, hn, v_hd)
    out = torch.einsum("bhc,chv->bhv", ctx, w_uv).reshape(b, 1, hn * v_hd)
    return row_linear(out, params["wo"], sv, h * v_hd, h_lo * v_hd), cache
