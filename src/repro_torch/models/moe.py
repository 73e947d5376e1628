"""Mixture-of-Experts block, DeepSeek-V2 style: shared experts plus routed
top-k (port of `repro.models.moe`).

Dispatch is capacity-based scatter and gather over dense buffers, as in
JAX:

  1. router softmax over E experts in f32, top-k a token, the k weights
     renormalised to sum to 1;
  2. token t's j-th choice goes to the next free slot of its expert's
     buffer (a running count over the flattened (token, choice) order);
     choices past the capacity C = max(1, int(T k capacity_factor / E))
     are dropped, and the weights are not renormalised after the drop;
  3. the tokens are scattered into [E, C, d] (`index_add`), the expert FFN
     runs as batched matrix products, and the outputs are gathered back
     and summed a token with their routing weights (`index_add`);
  4. the shared experts run densely on every token.

The top k of the router's probabilities come from a stable descending
sort: among equal probabilities the lower expert index comes first, as
`jax.lax.top_k` returns them (`torch.topk` promises no order for ties).
Aux losses, in f32: the switch-style load balance (routed choices counted
before the drop) and the router z-loss.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, linear

__all__ = ["moe_init", "moe_apply", "moe_capacity"]


def moe_init(generator: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    d, e, ffe = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    params = {
        "router": dense_init(generator, (d, e), dtype, fan_in=d),
        "w_gate": dense_init(generator, (e, d, ffe), dtype, fan_in=d),
        "w_up": dense_init(generator, (e, d, ffe), dtype, fan_in=d),
        "w_down": dense_init(generator, (e, ffe, d), dtype, fan_in=ffe),
    }
    if cfg.n_shared_experts:
        sff = cfg.n_shared_experts * ffe
        params["shared"] = {
            "w_gate": dense_init(generator, (d, sff), dtype),
            "w_up": dense_init(generator, (d, sff), dtype),
            "w_down": dense_init(generator, (sff, d), dtype),
        }
    return params


def moe_capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots an expert's buffer holds for `tokens` tokens (Python's
    truncation, at least 1)."""
    return max(1, int(tokens * cfg.moe_top_k * cfg.capacity_factor / cfg.n_experts))


def moe_apply(params: dict, cfg: ModelConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (y [B, S, d], aux loss f32 scalar)."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.moe_top_k
    xf = x.reshape(t, d)

    logits = linear(xf, params["router"]).float()  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :k], top_i[:, :k]  # [T, K]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    capacity = moe_capacity(cfg, t)
    # slot of each (token, choice) within its expert buffer: the number of
    # earlier choices routed to the same expert
    expert_of = top_i.reshape(t * k)
    flat_oh = F.one_hot(expert_of, e)  # [T*K, E]
    slot = (torch.cumsum(flat_oh, dim=0) - flat_oh).gather(1, expert_of[:, None])[:, 0]
    keep = slot < capacity
    dest = expert_of * capacity + torch.clamp(slot, max=capacity - 1)

    tok_of = torch.arange(t, device=x.device).repeat_interleave(k)
    contrib = torch.where(keep[:, None], xf[tok_of], torch.zeros((), dtype=xf.dtype,
                                                                 device=x.device))
    buf = torch.zeros((e * capacity, d), dtype=xf.dtype, device=x.device).index_add(
        0, dest, contrib).reshape(e, capacity, d)

    h = F.silu(torch.bmm(buf, params["w_gate"])) * torch.bmm(buf, params["w_up"])
    out_buf = torch.bmm(h, params["w_down"]).reshape(e * capacity, d)

    weight = torch.where(keep, top_p.reshape(t * k), 0.0)
    y = torch.zeros((t, d), dtype=xf.dtype, device=x.device).index_add(
        0, tok_of, out_buf[dest] * weight[:, None].to(xf.dtype))

    if cfg.n_shared_experts:
        sp = params["shared"]
        y = y + linear(F.silu(linear(xf, sp["w_gate"])) * linear(xf, sp["w_up"]), sp["w_down"])

    # aux losses, in f32
    me = probs.mean(dim=0)  # mean router probability
    routed = flat_oh.reshape(t, k, e).sum(dim=1) > 0
    ce = routed.float().mean(dim=0)  # routed fraction, dropped choices included
    lb_loss = e * torch.sum(me * ce) * cfg.router_aux_coef
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2) * cfg.router_z_coef
    return y.reshape(b, s, d), lb_loss + z_loss
