"""Mamba2 block, state-space duality (SSD), arXiv:2405.21060 (port of
`repro.models.ssm`).

Projections come fused (one ``in_proj`` and one conv over the x, B, C
streams) or, with ``cfg.ssm_split_proj``, split: one projection a stream
(``in_z``, ``in_x``, ``in_B``, ``in_C``, ``in_dt``) and one conv each for
x, B and C.  Both keep the decode cache's fused conv layout [x, B, C].

Full-sequence path: the chunked SSD algorithm, the intra-chunk quadratic
form (the SSD kernel when ``cfg.use_ssd_kernel``) plus the inter-chunk
recurrence h_k = decay_k h_{k-1} + s_k.  JAX runs that recurrence as an
associative scan; here it is a blocked scan in f32 (`_inter_chunk`), whose
sums run in another order, so parity with JAX holds to a tolerance.  Decode is
the O(1) recurrence h <- h exp(dt A) + dt B (x) x, y = C.h + D x.

dtypes follow JAX: ``A_log``, ``D`` and ``dt_bias`` are f32 leaves in any
model, dt is f32 after softplus and the recurrent state is f32.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_intra_chunk_ref
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, linear, rms_norm

__all__ = ["SSMCache", "mamba_init", "mamba_apply", "mamba_decode", "init_ssm_cache"]


class SSMCache(NamedTuple):
    conv: torch.Tensor   # [B, d_conv-1, conv_dim]: the last pre-conv inputs
    state: torch.Tensor  # [B, H, P, N] f32: the SSD recurrent state


def mamba_init(generator: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    d, di, g, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    dev = generator.device
    zeros = lambda c: torch.zeros((c,), dtype=dtype, device=dev)  # noqa: E731
    conv = lambda c: dense_init(generator, (cfg.d_conv, c), dtype, fan_in=cfg.d_conv)  # noqa: E731
    common = {
        "A_log": torch.zeros((h,), dtype=torch.float32, device=dev),  # A = -1
        "D": torch.ones((h,), dtype=torch.float32, device=dev),
        "dt_bias": torch.full((h,), -2.0, dtype=torch.float32, device=dev),
        "norm": torch.ones((di,), dtype=dtype, device=dev),
        "out_proj": dense_init(generator, (di, d), dtype),
    }
    if cfg.ssm_split_proj:
        return {
            **common,
            "in_z": dense_init(generator, (d, di), dtype),
            "in_x": dense_init(generator, (d, di), dtype),
            "in_B": dense_init(generator, (d, g * n), dtype),
            "in_C": dense_init(generator, (d, g * n), dtype),
            "in_dt": dense_init(generator, (d, h), dtype),
            "conv_x_w": conv(di), "conv_x_b": zeros(di),
            "conv_B_w": conv(g * n), "conv_B_b": zeros(g * n),
            "conv_C_w": conv(g * n), "conv_C_b": zeros(g * n),
        }
    return {
        **common,
        "in_proj": dense_init(generator, (d, 2 * di + 2 * g * n + h), dtype),
        "conv_w": conv(cfg.conv_dim),
        "conv_b": zeros(cfg.conv_dim),
    }


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    di = cfg.d_inner
    z = proj[..., :di]
    xbc = proj[..., di: di + cfg.conv_dim]
    dt = proj[..., di + cfg.conv_dim:]
    return z, xbc, dt


def _causal_conv(cfg: ModelConfig, xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Depthwise causal conv over time; xbc [B, S, C]."""
    k = cfg.d_conv
    s = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i: i + s, :] * w[i][None, None] for i in range(k))
    return F.silu(out + b[None, None])


def _split_xbc(cfg: ModelConfig, xbc: torch.Tensor):
    di, g, n = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    shp = tuple(xbc.shape[:-1])
    return (
        xbc[..., :di].reshape(shp + (cfg.ssm_heads, cfg.ssm_head_dim)),
        xbc[..., di: di + g * n].reshape(shp + (g, n)),
        xbc[..., di + g * n:].reshape(shp + (g, n)),
    )


def _inter_chunk(
    cc: torch.Tensor,           # [B, Nc, L, G, N]
    cum: torch.Tensor,          # [B, Nc, L, H] f32, within-chunk cumulative dt * A
    states: torch.Tensor,       # [B, Nc, H, P, N] f32, each chunk's state from zero
    h0: Optional[torch.Tensor],  # [B, H, P, N] f32
    dtype: torch.dtype,         # of the output term
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The inter-chunk recurrence h_k = exp(sum of chunk k's dt A) h_{k-1}
    + s_k in f32 and its output term y_i += exp(cum_i) C_i . h_{k-1}.
    Returns (y_inter [B, Nc, L, H, P] in `dtype`, final state).

    The Nc chunks are cut into nb blocks of K ~ sqrt(Nc) (the last padded
    with decay 1 and state 0).  One pass over the K offsets, all blocks at
    once, gives each block's state from zero; a loop over the nb blocks
    carries the state into each block; a second pass over the offsets
    rebuilds every chunk's incoming state from its block's carry and takes
    its output term, with C read group-wise (no copy of C per head).  So
    2K + nb host steps instead of Nc, and no [B, Nc, H, P, N] buffer beside
    `states` (at 524,288 tokens, N = 128: 4096 chunks, 8.6 GB a copy)."""
    bsz, nc, l, g, n = cc.shape
    h, p = states.shape[2], states.shape[3]
    k = math.isqrt(nc - 1) + 1 if nc > 1 else 1
    nb = -(-nc // k)
    log_a = cum[:, :, -1, :]  # [B, Nc, H]: log of each chunk's decay
    pad = nb * k - nc
    if pad:
        log_a = F.pad(log_a, (0, 0, 0, pad))
        states = F.pad(states, (0, 0) * 3 + (0, pad))
        cc = F.pad(cc, (0, 0) * 3 + (0, pad))
        cum = F.pad(cum, (0, 0) * 2 + (0, pad))
    decay = torch.exp(log_a).reshape(bsz, nb, k, h, 1, 1)
    block_decay = torch.exp(log_a.reshape(bsz, nb, k, h).sum(2))[..., None, None]
    s = states.reshape(bsz, nb, k, h, p, n)

    run = torch.zeros((bsz, nb, h, p, n), dtype=torch.float32, device=states.device)
    for j in range(k):  # each block's state from zero
        run = run * decay[:, :, j] + s[:, :, j]
    carry = torch.zeros_like(run[:, 0]) if h0 is None else h0.float()
    carries = []
    for b in range(nb):  # the state entering each block
        carries.append(carry)
        carry = carry * block_decay[:, b] + run[:, b]
    run = torch.stack(carries, dim=1)

    ccb = cc.reshape(bsz, nb, k, l, g, n)
    scale = torch.exp(cum).reshape(bsz, nb, k, l, h, 1)
    y = torch.empty((bsz, nb, k, l, h, p), dtype=dtype, device=cc.device)
    for j in range(k):  # each chunk's incoming state, and its output term
        inner = torch.einsum("bclgn,bcgrpn->bclgrp", ccb[:, :, j].float(),
                             run.reshape(bsz, nb, g, h // g, p, n))
        y[:, :, j] = (inner.reshape(bsz, nb, l, h, p) * scale[:, :, j]).to(y.dtype)
        run = run * decay[:, :, j] + s[:, :, j]
    return y.reshape(bsz, nb * k, l, h, p)[:, :nc], carry


def _ssd_chunked(
    cfg: ModelConfig,
    x: torch.Tensor,   # [B, S, H, P]
    dt: torch.Tensor,  # [B, S, H] f32 (post-softplus)
    a: torch.Tensor,   # [H] negative
    b_: torch.Tensor,  # [B, S, G, N]
    c_: torch.Tensor,  # [B, S, G, N]
    h0: Optional[torch.Tensor] = None,  # [B, H, P, N]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y [B, S, H, P], final_state [B, H, P, N] f32)."""
    bsz, s, h, p = x.shape
    g, n = b_.shape[2], b_.shape[3]
    l = min(cfg.ssm_chunk, s)
    pad = (-s) % l
    if pad:
        x, dt, b_, c_ = (F.pad(u, (0, 0) * (u.dim() - 2) + (0, pad)) for u in (x, dt, b_, c_))
    nc = (s + pad) // l
    xc = x.reshape(bsz, nc, l, h, p)
    dtc = dt.reshape(bsz, nc, l, h)
    bc = b_.reshape(bsz, nc, l, g, n)
    cc = c_.reshape(bsz, nc, l, g, n)
    rep = h // g
    cum = torch.cumsum(dtc * a[None, None, None], dim=2)  # within-chunk
    intra = ssd_ops.ssd_intra_chunk if cfg.use_ssd_kernel else ssd_intra_chunk_ref
    y_intra, chunk_state = intra(xc, dtc, cum, bc, cc, rep)

    y_inter, final_state = _inter_chunk(cc, cum, chunk_state, h0, y_intra.dtype)
    y = (y_intra + y_inter).reshape(bsz, nc * l, h, p)
    return y[:, :s], final_state


def _project(params: dict, cfg: ModelConfig, x: torch.Tensor):
    """Returns (z, xs [B,S,H,P], b_ [B,S,G,N], c_, dt_raw, xbc_preconv)."""
    if cfg.ssm_split_proj:
        bsz, s, _ = x.shape
        g, n = cfg.ssm_groups, cfg.ssm_state
        raw = {c: linear(x, params[f"in_{c}"]) for c in ("x", "B", "C")}
        conv = {c: _causal_conv(cfg, raw[c], params[f"conv_{c}_w"], params[f"conv_{c}_b"])
                for c in raw}
        xbc = torch.cat([raw["x"], raw["B"], raw["C"]], dim=-1)  # the cache's layout
        return (linear(x, params["in_z"]),
                conv["x"].reshape(bsz, s, cfg.ssm_heads, cfg.ssm_head_dim),
                conv["B"].reshape(bsz, s, g, n), conv["C"].reshape(bsz, s, g, n),
                linear(x, params["in_dt"]), xbc)
    proj = linear(x, params["in_proj"])
    z, xbc, dt_raw = _split_proj(cfg, proj)
    xbc_conv = _causal_conv(cfg, xbc, params["conv_w"], params["conv_b"])
    xs, b_, c_ = _split_xbc(cfg, xbc_conv)
    return z, xs, b_, c_, dt_raw, xbc


def mamba_apply(
    params: dict,
    cfg: ModelConfig,
    x: torch.Tensor,  # [B, S, d]
    return_cache: bool = False,
) -> Tuple[torch.Tensor, Optional[SSMCache]]:
    bsz, s, _ = x.shape
    z, xs, b_, c_, dt_raw, xbc = _project(params, cfg, x)
    dt = F.softplus(dt_raw.float() + params["dt_bias"][None, None])
    a = -torch.exp(params["A_log"])
    y, final_state = _ssd_chunked(cfg, xs, dt, a, b_, c_)
    y = y + xs * params["D"][None, None, :, None].to(xs.dtype)
    y = y.reshape(bsz, s, cfg.d_inner)
    y = rms_norm(y * F.silu(z), params["norm"])
    out = linear(y, params["out_proj"])
    cache = None
    if return_cache:
        # the last d_conv - 1 pre-conv inputs (zeros before the first), a
        # copy: a view would keep the whole [B, S, conv_dim] input alive
        tail = cfg.d_conv - 1
        conv_tail = F.pad(xbc[:, -tail:], (0, 0, max(0, tail - s), 0)).clone()
        cache = SSMCache(conv=conv_tail, state=final_state)
    return out, cache


def mamba_decode(
    params: dict,
    cfg: ModelConfig,
    x: torch.Tensor,  # [B, 1, d]
    cache: SSMCache,
) -> Tuple[torch.Tensor, SSMCache]:
    """One token.  Updates `cache` (the conv window and the state) in place
    and returns it."""
    bsz = x.shape[0]
    if cfg.ssm_split_proj:
        di, gn = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state
        z = linear(x, params["in_z"])
        xbc = torch.cat([linear(x, params[f"in_{c}"]) for c in ("x", "B", "C")], dim=-1)
        dt_raw = linear(x, params["in_dt"])
        window = torch.cat([cache.conv, xbc], dim=1)  # [B, d_conv, C]
        conv_out = torch.cat([
            torch.einsum("bkc,kc->bc", window[:, :, lo:hi], params[f"conv_{c}_w"])
            + params[f"conv_{c}_b"]
            for lo, hi, c in ((0, di, "x"), (di, di + gn, "B"), (di + gn, di + 2 * gn, "C"))
        ], dim=-1)
    else:
        z, xbc, dt_raw = _split_proj(cfg, linear(x, params["in_proj"]))
        window = torch.cat([cache.conv, xbc], dim=1)  # [B, d_conv, C]
        conv_out = torch.einsum("bkc,kc->bc", window, params["conv_w"]) + params["conv_b"]
    conv_out = F.silu(conv_out)[:, None]          # [B, 1, C]
    xs, b_, c_ = _split_xbc(cfg, conv_out)
    dt = F.softplus(dt_raw.float() + params["dt_bias"][None, None])
    a = -torch.exp(params["A_log"])
    da = torch.exp(dt[:, 0] * a[None])            # [B, H]
    rep = cfg.ssm_heads // cfg.ssm_groups
    bh = b_[:, 0].repeat_interleave(rep, dim=1)   # [B, H, N]
    chh = c_[:, 0].repeat_interleave(rep, dim=1)
    contrib = (dt[:, 0][..., None, None] * xs[:, 0][..., None]) * bh[:, :, None, :]
    state = cache.state
    state.mul_(da[..., None, None]).add_(contrib.to(state.dtype))
    y = torch.einsum("bhpn,bhn->bhp", state, chh.to(state.dtype))
    y = y.to(xs.dtype) + xs[:, 0] * params["D"][None, :, None].to(xs.dtype)
    y = y.reshape(bsz, 1, cfg.d_inner)
    y = rms_norm(y * F.silu(z), params["norm"])
    out = linear(y, params["out_proj"])
    cache.conv.copy_(window[:, 1:])
    return out, cache


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, device) -> SSMCache:
    return SSMCache(
        conv=torch.zeros((batch, cfg.d_conv - 1, cfg.conv_dim), dtype=dtype, device=device),
        state=torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                          dtype=torch.float32, device=device),
    )
