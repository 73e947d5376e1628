"""Gossip neighbour contraction in padded form (port of `repro.core.mixing`).

Every padded gossip path — here, PaME's sparse partial exchange
(`repro_torch.core.pme.pme_average_pytree_padded`) — routes through one
core, `gather_terms`: for each (w, x) term, out_i = sum_slot w[i, slot] ·
x[nbrs[i, slot]], all terms riding one walk of the [m, k] neighbour table.
Three interchangeable implementations:

  * impl="slots"  — one gather + multiply-add per neighbour slot, in
    ascending slot order (separately rounded multiply and add).  The
    reference arithmetic; padding weights of exactly 0.0 are IEEE no-ops.
  * impl="segsum" — the table flattened once into an [m·k] edge list, each
    term aggregated with two gathers and one `index_add_` over receiver
    segments; padding slots go to a dead segment m and are discarded.
    Agrees with "slots" to fp tolerance (other reduction order).
  * impl="kernel" — the hand-written CUDA kernel
    (`repro_torch.kernels.gossip`), which computes the "slots" arithmetic
    bit for bit.  On CPU tensors its wrapper takes the plain dense-scatter
    contraction instead.

`default_impl` departs from the JAX package here: JAX picks "slots" on CPU
and "segsum" on accelerators (its Pallas kernel is opt-in), while the port
picks "slots" for CPU tensors and "kernel" for CUDA tensors, because the
kernel is what runs on the card.  "segsum" stays as an opt-in impl and is
the yardstick the chip smoke times.  The process-wide override is the
port's own variable, ``REPRO_TORCH_GOSSIP_IMPL`` (not the JAX package's
``REPRO_GOSSIP_IMPL``, which CI jobs export for whole runs).

`Mixer` and `make_mixer` arrive with the baselines.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.tree import tree_map

__all__ = [
    "PaddedMixing", "mix_padded", "gather_terms", "default_impl", "env_impl",
    "IMPLS", "ENV_VAR",
]

# The closed set of contraction implementations; every entry point that
# accepts an impl validates against it, so a typo fails loudly everywhere.
IMPLS = ("slots", "segsum", "kernel")
ENV_VAR = "REPRO_TORCH_GOSSIP_IMPL"


def _check_impl(impl: str, source: str = "impl") -> str:
    if impl not in IMPLS:
        raise ValueError(
            f"{source}={impl!r}; expected one of {', '.join(map(repr, IMPLS))}"
        )
    return impl


def env_impl() -> Optional[str]:
    """The impl forced by ``REPRO_TORCH_GOSSIP_IMPL``, or None."""
    env = os.environ.get(ENV_VAR)
    return _check_impl(env, ENV_VAR) if env else None


def default_impl(device: Optional[torch.device] = None) -> str:
    """The contraction for tensors on `device`: the env variable wins, else
    "kernel" on CUDA and "slots" anywhere else."""
    env = env_impl()
    if env:
        return env
    return "kernel" if device is not None and torch.device(device).type == "cuda" else "slots"


class PaddedMixing(NamedTuple):
    """A mixing matrix in padded neighbour-exchange form: nbrs[i, slot]
    lists N_i ∪ {i} (padding repeats i), w[i, slot] is the receive weight
    (exactly 0.0 on padding), is_self marks the receiver's own slot and pad
    the structural padding slots (None = no padding information)."""

    nbrs: torch.Tensor     # [m, k] int
    w: torch.Tensor        # [m, k] float32
    is_self: torch.Tensor  # [m, k] bool
    pad: Optional[torch.Tensor] = None


def _bcast(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-node vector [m] shaped to broadcast over leaf x [m, ...]."""
    return v.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype)


def _gather_terms_slots(nbrs, terms):
    """Sequential chain in ascending slot order: acc = w0·x0, then
    acc = acc + w_s·x_s, each product and sum rounded on its own."""
    idx = nbrs.long()
    k = idx.shape[1]
    accs = [_bcast(w[:, 0], x) * x[idx[:, 0]] for w, x in terms]
    for slot in range(1, k):
        j = idx[:, slot]
        accs = [acc + _bcast(w[:, slot], x) * x[j] for acc, (w, x) in zip(accs, terms)]
    return tuple(accs)


def _gather_terms_segsum(nbrs, terms, pad):
    """Edge list + `index_add_` per term; padding to a dead segment m."""
    m, k = nbrs.shape
    senders = nbrs.long().reshape(-1)
    rows = torch.arange(m, device=nbrs.device)[:, None].expand(m, k)
    if pad is None:
        recv, segments = rows.reshape(-1), m
    else:
        recv = torch.where(pad, torch.full_like(rows, m), rows).reshape(-1)
        segments = m + 1
    outs = []
    for w, x in terms:
        vals = _bcast(w.reshape(-1), x) * x[senders]
        seg = torch.zeros((segments,) + tuple(x.shape[1:]), dtype=vals.dtype,
                          device=x.device)
        seg.index_add_(0, recv, vals)
        outs.append(seg[:m])
    return tuple(outs)


def gather_terms(
    nbrs: torch.Tensor,                                   # [m, k] padded table
    terms: Sequence[Tuple[torch.Tensor, torch.Tensor]],   # ([m, k] w, [m, ...] x)
    *,
    pad: Optional[torch.Tensor] = None,                   # [m, k] padding slots
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, ...]:
    """One-pass neighbour contraction shared by every padded gossip path:
    for each (w, x) term, out_i = sum_slot w[i, slot] · x[nbrs[i, slot]].
    `impl=None` resolves through `default_impl` for the tensors' device."""
    impl = default_impl(nbrs.device) if impl is None else _check_impl(impl)
    if impl == "slots":
        return _gather_terms_slots(nbrs, terms)
    if impl == "segsum":
        return _gather_terms_segsum(nbrs, terms, pad)
    from repro_torch.kernels.gossip.ops import gather_terms_kernel

    return gather_terms_kernel(nbrs, terms, pad=pad)


def mix_padded(pm: PaddedMixing, tree, impl: Optional[str] = None):
    """Gossip out_i = sum_slot w[i, slot] · x[nbrs[i, slot]] for every leaf."""
    return tree_map(
        lambda x: gather_terms(pm.nbrs, [(pm.w, x)], pad=pm.pad, impl=impl)[0],
        tree,
    )
