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
  3. the tokens are scattered into [E, C, d], the expert FFN runs as
     batched matrix products, and the outputs are gathered back and summed
     a token with their routing weights;
  4. the shared experts run densely on every token.

Every sum is taken in a fixed order, so a step repeats bit for bit on the
card (JAX's does): a token's k weighted outputs are added choice by choice
over a [T, k, d] view, the order of JAX's scatter-add on the CPU, instead
of by an `index_add` (atomic adds on the card); each kept choice owns its
buffer slot and the dropped ones go to a spare row, so the dispatch adds
nothing twice; and a token is repeated for its k choices by an expand,
whose backward sums over the k axis, instead of by an index gather, whose
backward accumulates into repeated rows.

The top k of the router's probabilities come from a stable descending
sort: among equal probabilities the lower expert index comes first, as
`jax.lax.top_k` returns them (`torch.topk` promises no order for ties).
Aux losses, in f32: the switch-style load balance (routed choices counted
before the drop) and the router z-loss.

Sharded serving (a `repro_torch.sharding.Serve` view ``sv``): the routed
experts are expert-parallel over `model`.  The router is whole and every
rank routes the tokens of its rows.  The capacity and the slots are the
whole batch's, as in the unsharded layer: C is taken from the batch's
token count, and a choice's slot also counts the choices of the ranks that
hold earlier rows (their per-expert counts gathered over the rows' axes,
``use="routing"``), so the same choices are kept and dropped.  Each rank
runs its E / t experts on its own tokens' slots of their [C, d] buffers
(the other ranks' slots stay zero) and adds its kept choices' weighted
outputs; the partial outputs are summed over `model`
(``use="activations"``).  The aux losses are the rank's rows' (serving
drops them).  The shared experts are the tensor-parallel MLP
(`mlp.mlp_apply`).  Unsharded, the same body runs on
`sharding.serve_view(None)`.

In training (a `sharding.train_view`, the node's rows split over fsdp),
the capacity and the slots are the node's whole batch's in the same way,
the tokens and their routing weights enter the rank's experts through
`Serve.enter`, and the aux losses are the node's whole batch's: the sums
of the router probabilities, of the routed fractions and of the squared
log-partition over each rank's rows are summed over fsdp
(`Serve.rows_sum`, ``use="routing"``) before they are divided by the
node's token count.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch import sharding as shd
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, linear
from repro_torch.models.mlp import mlp_apply

__all__ = ["moe_init", "moe_apply", "moe_capacity"]

_UNSHARDED = shd.serve_view(None)


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


def moe_apply(params: dict, cfg: ModelConfig, x: torch.Tensor, sv=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (y [B, S, d], aux loss f32 scalar); under a sharded
    view `sv`, the rank's rows and experts (see the module's docstring)."""
    sv = sv or _UNSHARDED
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.moe_top_k
    xf = x.reshape(t, d)

    logits = linear(xf, params["router"]).float()  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :k], top_i[:, :k]  # [T, K]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # slot of each (token, choice) within its expert buffer: the number of
    # earlier choices of the batch routed to the same expert, those of the
    # ranks holding earlier rows first; the capacity is the batch's
    expert_of = top_i.reshape(t * k)
    flat_oh = F.one_hot(expert_of, e)  # [T*K, E]
    before, pieces = sv.rows_before(flat_oh.sum(dim=0))
    capacity = moe_capacity(cfg, t * pieces)
    slot = (torch.cumsum(flat_oh, dim=0) - flat_oh + before).gather(
        1, expert_of[:, None])[:, 0]
    # this rank's experts [e_lo, e_hi) and the choices routed to them
    e_lo, e_hi = sv.span(params["w_down"], 0, e)
    n_e = e_hi - e_lo
    mine = (expert_of >= e_lo) & (expert_of < e_hi)
    keep = (slot < capacity) & mine
    local = torch.where(mine, expert_of - e_lo, 0)
    dest = local * capacity + torch.clamp(slot, max=capacity - 1)

    # dispatch: kept choice (t, j) into its own slot of the rank's
    # [E_r·C + 1, d] buffer, any other into the spare last row (cut off)
    spare = torch.full_like(dest, n_e * capacity)
    xe, pe = (xf, top_p) if n_e == e else (sv.enter(xf), sv.enter(top_p))
    contrib = xe[:, None, :].expand(t, k, d).reshape(t * k, d)
    buf = torch.zeros((n_e * capacity + 1, d), dtype=xf.dtype, device=x.device).index_put(
        (torch.where(keep, dest, spare),), contrib)[:-1].reshape(n_e, capacity, d)

    w_gate, w_up = (sv.part(params[name], 0, e, e_lo, e_hi, f"moe/{name}")
                    for name in ("w_gate", "w_up"))
    h = F.silu(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_up)
    out_buf = torch.bmm(h, params["w_down"]).reshape(n_e * capacity, d)
    del buf, h

    # combine: a choice not kept here (dropped, or routed to another rank's
    # expert) reads a slot at weight 0 (a zero gradient there); the k terms
    # are added choice by choice
    weight = torch.where(keep, pe.reshape(t * k), 0.0)
    terms = (out_buf[dest] * weight[:, None].to(xf.dtype)).reshape(t, k, d)
    y = terms[:, 0]
    for j in range(1, k):
        y = y + terms[:, j]
    y = sv.psum(y)

    if cfg.n_shared_experts:
        y = y + mlp_apply(params["shared"], xf, sv, cfg.n_shared_experts * cfg.d_ff_expert,
                          "moe/shared")

    # aux losses, in f32, over the node's tokens
    def mean(u):
        if not (sv.train and sv.rows):
            return u.mean(dim=0)
        return sv.rows_sum(u.sum(dim=0), "routing") / (t * sv.pieces)

    me = mean(probs)  # mean router probability
    routed = flat_oh.reshape(t, k, e).sum(dim=1) > 0
    ce = mean(routed.float())  # routed fraction, dropped choices included
    lb_loss = e * torch.sum(me * ce) * cfg.router_aux_coef
    z_loss = mean(torch.logsumexp(logits, dim=-1) ** 2) * cfg.router_z_coef
    return y.reshape(b, s, d), lb_loss + z_loss
