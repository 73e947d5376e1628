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

Sharded serving (a `repro_torch.sharding.Serve` view ``sv``; unsharded, the
view of one rank and every piece whole): each rank runs the SSD on its H / t
heads (all H where t does not divide H, or where its heads do not cover
whole B / C groups or lie in one).  The fused ``in_proj`` and its conv
(``conv_w``, ``conv_b``) are split over `model` in column blocks that do
not line up with z / xBC / dt, so they are gathered over `model` and the
projection and conv computed replicated, the rank taking its heads from
the result; the split projections (``ssm_split_proj``) shard head-aligned:
``in_z`` / ``in_x`` / ``in_dt`` and the x conv column-parallel, B and C
replicated.  ``dt_bias``, ``A_log``, ``D`` and ``norm`` have no rule and
are whole.  The gated RMSNorm over the whole d_inner sums its squares over
`model` before it scales (``use="activations"``); ``out_proj`` is
row-parallel.  A rank's final state, and its x rows of the conv window
(split projections), are gathered over `model` into its whole cache
(``use="cache"``).

In training (a `sharding.train_view`, full sequence only), what every model
rank holds whole and the rank's heads read goes through `Serve.enter` (its
gradient summed over `model`): the block's input where a projection is
split over the heads, the fused projection's z, conv output and dt before
they are cut to the rank's heads, the split projections' B and C convs,
``dt_bias``, ``A_log``, ``D`` and the norm's scale on the rank's heads, and
the gated norm's sum of squares after its sum over `model`.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import sharding as shd
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_intra_chunk_ref
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, linear, rms_norm, row_linear

__all__ = ["SSMCache", "mamba_init", "mamba_apply", "mamba_decode", "init_ssm_cache"]

_UNSHARDED = shd.serve_view(None)


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


class _Heads(NamedTuple):
    """A rank's SSD heads [h_lo, h_hi) and the B / C groups [g_lo, g_hi)
    they read (rep heads a group)."""

    h_lo: int
    h_hi: int
    g_lo: int
    g_hi: int

    @property
    def rep(self) -> int:
        return (self.h_hi - self.h_lo) // (self.g_hi - self.g_lo)


def _ssm_heads(cfg: ModelConfig, sv) -> _Heads:
    h, g = cfg.ssm_heads, cfg.ssm_groups
    rep = h // g
    lo, hi = sv.heads(h)
    g_lo, g_hi = lo // rep, (hi - 1) // rep + 1
    if (hi - lo) % (g_hi - g_lo) == 0 and (g_hi - g_lo == 1 or lo % rep == 0):
        return _Heads(lo, hi, g_lo, g_hi)
    return _Heads(0, h, 0, g)


def _project(params: dict, cfg: ModelConfig, x: torch.Tensor, sv, hs: _Heads):
    """Returns (z, xs [B,S,h,P], b_ [B,S,g,N], c_, dt_raw, xbc_preconv) on
    the rank's h heads and g groups; xbc_preconv is whole over `model`
    (the cache's conv window) except the split projections' x part, which
    is the rank's (`_whole_xbc` gathers it)."""
    p = cfg.ssm_head_dim
    di, gn, n = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state, cfg.ssm_state
    bsz, s, _ = x.shape
    split = hs.h_hi - hs.h_lo < cfg.ssm_heads
    if cfg.ssm_split_proj:
        lo, hi = hs.h_lo * p, hs.h_hi * p
        xe = sv.enter(x) if split else x
        w = {"x": sv.part(params["in_x"], 1, di, lo, hi, "mamba/in_x"),
             "B": params["in_B"], "C": params["in_C"]}
        cw = {"x": sv.part(params["conv_x_w"], 1, di, lo, hi, "mamba/conv_x_w"),
              "B": params["conv_B_w"], "C": params["conv_C_w"]}
        cb = {"x": sv.part(params["conv_x_b"], 0, di, lo, hi, "mamba/conv_x_b"),
              "B": params["conv_B_b"], "C": params["conv_C_b"]}
        raw = {c: linear(xe if c == "x" else x, w[c]) for c in ("x", "B", "C")}
        conv = {c: _causal_conv(cfg, raw[c], cw[c], cb[c]) for c in raw}
        xbc = torch.cat([raw["x"], raw["B"], raw["C"]], dim=-1)  # the cache's layout
        gsl = slice(hs.g_lo * n, hs.g_hi * n)
        ng = hs.g_hi - hs.g_lo
        if split:
            conv["B"], conv["C"] = sv.enter(conv["B"]), sv.enter(conv["C"])
        return (linear(xe, sv.part(params["in_z"], 1, di, lo, hi, "mamba/in_z")),
                conv["x"].reshape(bsz, s, hs.h_hi - hs.h_lo, p),
                conv["B"][..., gsl].reshape(bsz, s, ng, n),
                conv["C"][..., gsl].reshape(bsz, s, ng, n),
                linear(xe, sv.part(params["in_dt"], 1, cfg.ssm_heads, hs.h_lo, hs.h_hi,
                                   "mamba/in_dt")), xbc)
    width = 2 * di + 2 * gn + cfg.ssm_heads
    proj = linear(x, sv.part(params["in_proj"], 1, width, 0, width, "mamba/in_proj"))
    z, xbc, dt_raw = _split_proj(cfg, proj)
    cd = cfg.conv_dim
    xbc_conv = _causal_conv(cfg, xbc, sv.part(params["conv_w"], 1, cd, 0, cd, "mamba/conv_w"),
                            sv.part(params["conv_b"], 0, cd, 0, cd, "mamba/conv_b"))
    if split:  # computed whole on every rank, cut to its heads
        z, xbc_conv, dt_raw = sv.enter(z), sv.enter(xbc_conv), sv.enter(dt_raw)
    xs, b_, c_ = _split_xbc(cfg, xbc_conv)
    return _own_heads(cfg, hs, z, xs, b_, c_, dt_raw) + (xbc,)


def _own_heads(cfg: ModelConfig, hs: _Heads, z, xs, b_, c_, dt_raw):
    """The rank's heads and groups of whole z / xs / B / C / dt (the
    tensors themselves when it computes all of them)."""
    if (hs.h_lo, hs.h_hi) == (0, cfg.ssm_heads):
        return z, xs, b_, c_, dt_raw
    p = cfg.ssm_head_dim
    return (z[..., hs.h_lo * p: hs.h_hi * p], xs[..., hs.h_lo: hs.h_hi, :].contiguous(),
            b_[..., hs.g_lo: hs.g_hi, :], c_[..., hs.g_lo: hs.g_hi, :],
            dt_raw[..., hs.h_lo: hs.h_hi])


def _gated_norm(cfg: ModelConfig, y: torch.Tensor, z: torch.Tensor, norm: torch.Tensor, sv,
                hs: _Heads, eps: float = 1e-6) -> torch.Tensor:
    """rms_norm(y * silu(z)) over the whole d_inner.  On a rank's heads the
    sum of squares is summed over `model` first (in f32), then each rank
    scales its own columns: the same function as the whole norm."""
    if y.shape[-1] == cfg.d_inner:
        return rms_norm(y * F.silu(z), norm, eps)
    g = (y * F.silu(z)).float()
    ss = sv.enter(sv.psum(torch.sum(g * g, dim=-1, keepdim=True), "activations"))
    p = cfg.ssm_head_dim
    out = g * torch.rsqrt(ss / cfg.d_inner + eps)
    return (out * sv.enter(norm)[hs.h_lo * p: hs.h_hi * p].float()).to(y.dtype)


def _whole_xbc(cfg: ModelConfig, xbc: torch.Tensor, sv) -> torch.Tensor:
    """The conv window's rows [..., conv_dim] whole over `model`: the split
    projections' x part is the rank's, gathered (``use="cache"``)."""
    if xbc.shape[-1] == cfg.conv_dim:
        return xbc
    nx = xbc.shape[-1] - 2 * cfg.ssm_groups * cfg.ssm_state
    return torch.cat([sv.cat(xbc[..., :nx].contiguous(), -1, "cache"), xbc[..., nx:]], dim=-1)


def mamba_apply(
    params: dict,
    cfg: ModelConfig,
    x: torch.Tensor,  # [B, S, d]
    return_cache: bool = False,
    sv=None,
) -> Tuple[torch.Tensor, Optional[SSMCache]]:
    """The block over a full sequence; under a sharded view `sv`, the SSD on
    the rank's heads and the cache whole over `model`."""
    bsz, s, _ = x.shape
    sv = sv or _UNSHARDED
    hs = _ssm_heads(cfg, sv)
    z, xs, b_, c_, dt_raw, xbc = _project(params, cfg, x, sv, hs)
    sl = slice(hs.h_lo, hs.h_hi)
    # the per-head leaves, whole on every rank, on the rank's heads
    dt_bias, a_log, d_skip = (params[k] if sl == slice(0, cfg.ssm_heads) else
                              sv.enter(params[k]) for k in ("dt_bias", "A_log", "D"))
    dt = F.softplus(dt_raw.float() + dt_bias[sl][None, None])
    a = -torch.exp(a_log[sl])
    y, final_state = _ssd_chunked(cfg, xs, dt, a, b_, c_)
    y = y + xs * d_skip[sl][None, None, :, None].to(xs.dtype)
    y = y.reshape(bsz, s, -1)
    y = _gated_norm(cfg, y, z, params["norm"], sv, hs)
    p = cfg.ssm_head_dim
    out = row_linear(y, params["out_proj"], sv, cfg.d_inner, hs.h_lo * p)
    cache = None
    if return_cache:
        # the last d_conv - 1 pre-conv inputs (zeros before the first), a
        # copy: a view would keep the whole [B, S, conv_dim] input alive
        tail = cfg.d_conv - 1
        conv_tail = F.pad(_whole_xbc(cfg, xbc[:, -tail:], sv),
                          (0, 0, max(0, tail - s), 0)).clone()
        if final_state.shape[1] < cfg.ssm_heads:
            final_state = sv.cat(final_state, 1, "cache")
        cache = SSMCache(conv=conv_tail, state=final_state)
    return out, cache


def mamba_decode(
    params: dict,
    cfg: ModelConfig,
    x: torch.Tensor,  # [B, 1, d]
    cache: SSMCache,
    sv=None,
) -> Tuple[torch.Tensor, SSMCache]:
    """One token.  Updates `cache` (the conv window and the state) in place
    and returns it; under a sharded view `sv` the rank updates its heads of
    the state and gathers them into the whole cache."""
    bsz = x.shape[0]
    sv = sv or _UNSHARDED
    hs = _ssm_heads(cfg, sv)
    p, n = cfg.ssm_head_dim, cfg.ssm_state
    if cfg.ssm_split_proj:
        di, gn = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state
        lo, hi = hs.h_lo * p, hs.h_hi * p
        z = linear(x, sv.part(params["in_z"], 1, di, lo, hi, "mamba/in_z"))
        xn = linear(x, sv.part(params["in_x"], 1, di, lo, hi, "mamba/in_x"))
        xbc = torch.cat([xn] + [linear(x, params[f"in_{c}"]) for c in ("B", "C")], dim=-1)
        dt_raw = linear(x, sv.part(params["in_dt"], 1, cfg.ssm_heads, hs.h_lo, hs.h_hi,
                                   "mamba/in_dt"))
        # the rank's columns of the window: its x part, then B and C
        own = torch.cat([cache.conv[..., lo:hi], cache.conv[..., di:]], dim=-1)
        window = torch.cat([own, xbc], dim=1)  # [B, d_conv, hi - lo + 2 gn]
        nx = hi - lo
        conv_out = torch.cat([
            torch.einsum("bkc,kc->bc", window[:, :, a:b], w) + bias
            for a, b, w, bias in (
                (0, nx, sv.part(params["conv_x_w"], 1, di, lo, hi, "mamba/conv_x_w"),
                 sv.part(params["conv_x_b"], 0, di, lo, hi, "mamba/conv_x_b")),
                (nx, nx + gn, params["conv_B_w"], params["conv_B_b"]),
                (nx + gn, nx + 2 * gn, params["conv_C_w"], params["conv_C_b"]))
        ], dim=-1)
        conv_out = F.silu(conv_out)[:, None]
        g_sl = slice(hs.g_lo * n, hs.g_hi * n)
        xs = conv_out[..., :nx].reshape(bsz, 1, hs.h_hi - hs.h_lo, p)
        b_ = conv_out[..., nx: nx + gn][..., g_sl].reshape(bsz, 1, -1, n)
        c_ = conv_out[..., nx + gn:][..., g_sl].reshape(bsz, 1, -1, n)
        new_rows = _whole_xbc(cfg, xbc, sv)
        window = torch.cat([cache.conv, new_rows], dim=1)
    else:
        width = 2 * cfg.d_inner + 2 * cfg.ssm_groups * n + cfg.ssm_heads
        cd = cfg.conv_dim
        z, xbc, dt_raw = _split_proj(cfg, linear(x, sv.part(params["in_proj"], 1, width, 0,
                                                             width, "mamba/in_proj")))
        window = torch.cat([cache.conv, xbc], dim=1)  # [B, d_conv, C]
        conv_out = torch.einsum("bkc,kc->bc", window,
                                sv.part(params["conv_w"], 1, cd, 0, cd, "mamba/conv_w")) \
            + sv.part(params["conv_b"], 0, cd, 0, cd, "mamba/conv_b")
        conv_out = F.silu(conv_out)[:, None]          # [B, 1, C]
        xs, b_, c_ = _split_xbc(cfg, conv_out)
        z, xs, b_, c_, dt_raw = _own_heads(cfg, hs, z, xs, b_, c_, dt_raw)
    sl = slice(hs.h_lo, hs.h_hi)
    dt = F.softplus(dt_raw.float() + params["dt_bias"][sl][None, None])
    a = -torch.exp(params["A_log"][sl])
    da = torch.exp(dt[:, 0] * a[None])            # [B, h]
    rep = hs.rep
    bh = b_[:, 0].repeat_interleave(rep, dim=1)   # [B, h, N]
    chh = c_[:, 0].repeat_interleave(rep, dim=1)
    contrib = (dt[:, 0][..., None, None] * xs[:, 0][..., None]) * bh[:, :, None, :]
    state = cache.state[:, sl]
    state.mul_(da[..., None, None]).add_(contrib.to(state.dtype))
    y = torch.einsum("bhpn,bhn->bhp", state, chh.to(state.dtype))
    if state.shape[1] < cfg.ssm_heads:
        cache.state.copy_(sv.cat(state.contiguous(), 1, "cache"))
    y = y.to(xs.dtype) + xs[:, 0] * params["D"][sl][None, :, None].to(xs.dtype)
    y = y.reshape(bsz, 1, -1)
    y = _gated_norm(cfg, y, z, params["norm"], sv, hs)
    out = row_linear(y, params["out_proj"], sv, cfg.d_inner, hs.h_lo * p)
    cache.conv.copy_(window[:, 1:])
    return out, cache


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, device) -> SSMCache:
    return SSMCache(
        conv=torch.zeros((batch, cfg.d_conv - 1, cfg.conv_dim), dtype=dtype, device=device),
        state=torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                          dtype=torch.float32, device=device),
    )
