"""Partial Message Exchange (PME) — Algorithm 2 of the PaME paper
(port of `repro.core.pme`).

Every selected neighbour j of node i transmits only s_j randomly chosen
coordinates of w_j; node i averages coordinate l over the lambda_{i,l}
neighbours that sent it and fills missing coordinates from its own w_i.

Mask samplers: "exact" (s coordinates uniformly without replacement, the
paper's scheme) and "bernoulli" (each coordinate kept i.i.d. with
p = s/n).  Randomness comes from explicit `torch.Generator`s; pytree-level
functions take an integer `key` and derive one generator per leaf with
`fold_in(key, leaf_index)`, in JAX leaf order.  JAX's threefry streams
cannot be reproduced from torch, so every function that draws also
accepts its draws as an optional input (`u=` uniforms, `masks=` per-leaf
masks): the parity tests feed it the JAX package's draws.

On CUDA the exact-mode dense exchange sends leaves of at least 2^17
elements to the hand-written kernel (`repro_torch.kernels.pme_average`);
``REPRO_TORCH_GOSSIP_IMPL=kernel`` sends every such leaf, and ``slots`` or
``segsum`` keeps them all on the plain average.

Lanes (`core.lanes`): the pytree-level functions also take one key per
lane (an int64 ndarray [L]) over [L·m, ...] leaves, each lane's masks drawn from its own
key for its own m rows; the dense exchange then takes an [L, m, m]
selection, one [m, m] a lane, and sends a leaf of at least 2^17 elements
a lane to the kernel's lane axis in one launch; a self view
(``self_params``, the temporal and fault steps' fresh parameters) is
folded like the leaves, and each lane fills from its own rows.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import lanes as LN
from repro_torch.core.mixing import default_impl, env_impl, gather_terms
from repro_torch.tree import tree_flatten, tree_unflatten

__all__ = [
    "fold_in", "make_generator",
    "sample_coordinate_masks", "sample_bernoulli_masks",
    "sample_neighbor_selection", "sample_neighbor_selection_padded",
    "pme_average", "pme_average_pytree", "pme_average_pytree_padded",
    "naive_average", "message_bits", "leaf_rates", "tree_message_bits",
]

# exact-mode leaves at least this large go to the fused kernel on CUDA;
# smaller ones stay on the plain average (launch overhead dominates).
_KERNEL_MIN_ELEMS = 1 << 17


def fold_in(key: int, data: int) -> int:
    """A new seed from (key, data) — the role of `jax.random.fold_in`
    (different numbers: parity comes from injected draws)."""
    state = np.random.SeedSequence([int(key), int(data)]).generate_state(1, np.uint64)
    return int(state[0] >> np.uint64(1))


def make_generator(key: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(key))
    return g


def sample_coordinate_masks(
    generator: Optional[torch.Generator],
    m: int,
    n: int,
    s: int,
    mode: str = "exact",
    *,
    u: Optional[torch.Tensor] = None,  # [m, n] uniforms to use instead of drawing
) -> torch.Tensor:
    """Per-sender coordinate masks M: [m, n] bool, |M_j| = s (exact mode).

    Node j keeps the s coordinates with the smallest uniforms: T_j^k is a
    uniform s-subset of [n], independent across nodes (Setup 1.3).
    """
    if mode == "exact":
        device = generator.device if u is None else u.device
        if s >= n:  # dense exchange (s = n): every coordinate is sent
            return torch.ones((m, n), dtype=torch.bool, device=device)
        if u is None:
            u = torch.rand((m, n), generator=generator, device=device)
        idx = torch.topk(u, s, dim=1, largest=False, sorted=False).indices
        mask = torch.zeros((m, n), dtype=torch.bool, device=device)
        return mask.scatter_(1, idx, True)
    if mode == "bernoulli":
        return sample_bernoulli_masks(generator, s / n, (m, n), u=u)
    raise ValueError(f"unknown mask mode {mode!r}")


def sample_bernoulli_masks(
    generator: Optional[torch.Generator],
    p: float,
    shape: Tuple[int, ...],
    *,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Each coordinate kept i.i.d. with probability p (uniform < p, as
    `jax.random.bernoulli` draws it)."""
    if u is None:
        u = torch.rand(shape, generator=generator, device=generator.device)
    return u < p


def sample_neighbor_selection_padded(
    generator: Optional[torch.Generator],
    nbrs: torch.Tensor,       # [m, d] padded neighbour ids
    valid: torch.Tensor,      # [m, d] bool
    t: torch.Tensor,          # [m] int — t_i = max(1, floor(nu_i |N_i|))
    comm_mask: torch.Tensor,  # [m] bool — k in K_i?
    survivors: Optional[torch.Tensor] = None,  # [m, d] bool — realized edges
    *,
    u: Optional[torch.Tensor] = None,  # [m, d] uniforms to use instead of drawing
) -> torch.Tensor:
    """Random neighbour selection N_i^k (Alg. 1 line 5) in padded form:
    sel[i, slot] marks nbrs[i, slot] as selected by receiver i.  Receiver i
    keeps the t_i valid slots with the smallest uniforms; rows of
    non-communicating receivers are all False (Alg. 1 line 9)."""
    if survivors is not None:
        valid = valid & survivors
    m, d = nbrs.shape
    if u is None:
        u = torch.rand((m, d), generator=generator, device=nbrs.device)
    u = torch.where(valid, u, torch.full_like(u, float("inf")))  # never pick padding
    order = torch.sort(u, dim=1, stable=True).indices
    take = torch.arange(d, device=nbrs.device)[None, :] < t[:, None]
    sel = torch.zeros((m, d), dtype=torch.bool, device=nbrs.device).scatter_(1, order, take)
    return sel & valid & comm_mask[:, None]


def sample_neighbor_selection(
    generator: Optional[torch.Generator],
    nbrs: torch.Tensor,
    valid: torch.Tensor,
    t: torch.Tensor,
    comm_mask: torch.Tensor,
    survivors: Optional[torch.Tensor] = None,
    *,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The same selection as a matrix A: [m, m] float32, A[j, i] = 1 iff
    node j is a selected neighbour of receiver i (column i is N_i^k)."""
    m, d = nbrs.shape
    sel = sample_neighbor_selection_padded(
        generator, nbrs, valid, t, comm_mask, survivors=survivors, u=u
    )
    rows = torch.arange(m, device=nbrs.device)[:, None].expand(m, d)
    a = torch.zeros((m, m), dtype=torch.float32, device=nbrs.device)
    # padding slots scatter 0.0 onto A[i, i], an additive no-op
    return a.index_put_((nbrs.long(), rows), sel.float(), accumulate=True)


def pme_average(
    w: torch.Tensor,       # [m, n] node-stacked parameters
    masks: torch.Tensor,   # [m, n] bool per-sender coordinate masks
    a: torch.Tensor,       # [m, m] selection matrix, A[j, i] = j in N_i^k
    own: Optional[torch.Tensor] = None,  # [m, n] receiver's own view (default w)
) -> torch.Tensor:
    """Count-weighted PME average — Alg. 2 line 6, Eq. (6)/(7).

    v_bar[i, l] = sum_{j in N_i^k, l in T_j} w[j, l] / lambda_{i,l}, with
    fallback own[i, l] where lambda_{i,l} = 0.  Computed in f32 (the JAX
    version promotes to f32 through the f32 selection matrix) and returned
    in w's type, as the fused kernel returns it, so a leaf keeps its type
    whichever route it takes.
    """
    mf = masks.float()
    af = a.float()
    agg = torch.einsum("jn,ji->in", torch.where(masks.bool(), w, 0).float(), af)
    cnt = torch.einsum("jn,ji->in", mf, af)
    fallback = (w if own is None else own).float()
    return torch.where(cnt > 0, agg / torch.clamp(cnt, min=1.0), fallback).to(w.dtype)


def naive_average(w: torch.Tensor, masks: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """The *biased* strawman of Theorem 1: divide by |N_i^k| instead of
    lambda_{i,l}.  Expectation is (s/n) * mean — kept for tests."""
    wm = torch.where(masks.bool(), w, 0).float()
    agg = torch.einsum("jn,ji->in", wm, a.float())
    t = torch.clamp(a.float().sum(dim=0), min=1.0)
    return (agg / t[:, None]).to(w.dtype)


def _count_average(agg: torch.Tensor, cnt: torch.Tensor, fallback: torch.Tensor):
    """where(cnt > 0, agg / max(cnt, 1) in fallback's type, fallback).

    agg and cnt are scratch and are divided in place, which keeps a large
    leaf's f32 transients to these two."""
    has = cnt > 0
    agg.div_(cnt.clamp_(min=1.0))
    return torch.where(has, agg.to(fallback.dtype), fallback)


def _leaf_masks(masks, idx, key, device):
    """Injected masks of leaf idx, or one generator a lane for drawing
    them (`key` an int, or an int64 ndarray of per-lane keys)."""
    if masks is not None:
        return masks[idx].to(device), None
    if key is None:
        raise ValueError("pass either a key or the masks to use")
    return None, [make_generator(fold_in(k, idx), device) for k in LN.keys(key)]


def _draw_masks(gens, shape, p_i: float, mode: str) -> torch.Tensor:
    """A leaf's masks, [rows, n] (exact) or in the leaf's shape
    (Bernoulli): each lane's m = rows / L rows from its own generator."""
    m = shape[0] // len(gens)
    parts = []
    for gen in gens:
        if mode == "exact":
            parts.append(sample_coordinate_masks(gen, m, shape[1],
                                                 max(1, int(round(p_i * shape[1])))))
        else:
            parts.append(sample_bernoulli_masks(gen, p_i, (m,) + tuple(shape[1:])))
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def pme_average_pytree(
    key,                     # int, or one key per lane (int64 ndarray [L])
    params,  # pytree with [m, ...] leaves ([L·m, ...] for L lanes)
    a: torch.Tensor,         # [m, m], or [L, m, m] for L lanes
    p,  # float, or per-leaf rate sequence (tree partition — see leaf_rates)
    mode: str = "bernoulli",
    self_params=None,
    *,
    masks: Optional[Sequence[torch.Tensor]] = None,  # per-leaf draws, JAX order
):
    """Apply PME leaf-wise to a node-stacked parameter pytree.

    Each leaf is its own message segment; its masks are drawn from
    `fold_in(key, leaf_index)` (or taken from `masks`, exact mode as
    [m, n_leaf], Bernoulli mode in the leaf's shape).  A sequence of rates
    gives each leaf its own keep fraction.  `self_params` overrides the
    receiver's own view for the lambda = 0 fallback.  An [L, m, m]
    selection averages L lanes folded into the leaves' rows, each over its
    own m rows (masks drawn lane by lane from an ndarray of keys, the
    self view folded like the leaves); on the card an exact-mode leaf of
    at least 2^17 elements a lane takes the kernel's lane axis, one launch
    for all lanes.
    """
    leaves, treedef = tree_flatten(params)
    self_leaves = leaves if self_params is None else tree_flatten(self_params)[0]
    lanes = a.shape[0] if a.dim() == 3 else None
    rows = leaves[0].shape[0]
    m = rows // (lanes or 1)
    per_leaf = isinstance(p, (tuple, list))
    impl = default_impl(a.device)
    out = []
    for idx, leaf in enumerate(leaves):
        p_i = p[idx] if per_leaf else p
        mk, gens = _leaf_masks(masks, idx, key, leaf.device)
        own = self_leaves[idx]
        if mode == "exact":
            flat = leaf.reshape(rows, -1)
            n = flat.shape[1]
            if mk is None:
                mk = _draw_masks(gens, (rows, n), p_i, mode)
            mk = mk.reshape(rows, n)
            if self_params is None and impl == "kernel" and (
                env_impl() == "kernel" or m * n >= _KERNEL_MIN_ELEMS
            ):
                # hot path: the fused kernel (one read of W and the masks,
                # one write; all lanes in one launch).  It takes the
                # fallback from W itself, so a self-view override stays on
                # the plain average.
                from repro_torch.kernels.pme_average.ops import (
                    pme_average as pme_average_fused,
                )

                if lanes is None:
                    avg = pme_average_fused(flat.contiguous(), mk, a)
                else:
                    avg = pme_average_fused(flat.contiguous().view(lanes, m, n),
                                            mk.contiguous().view(lanes, m, n), a)
            elif lanes is not None:
                owns = ([None] * lanes if self_params is None
                        else own.reshape(rows, -1).chunk(lanes))
                avg = torch.cat([pme_average(w_l, mk_l, a_l, own=o_l) for w_l, mk_l, a_l, o_l in
                                 zip(flat.chunk(lanes), mk.chunk(lanes), a, owns)])
            elif self_params is None:
                avg = pme_average(flat, mk, a)
            else:
                avg = pme_average(flat, mk, a, own=own.reshape(m, -1))
            out.append(avg.reshape(leaf.shape))
        else:
            if mk is None:
                mk = _draw_masks(gens, tuple(leaf.shape), p_i, mode)
            # operands in the leaf's type, accumulation in f32 (JAX's
            # preferred_element_type=f32); 0/1 factors are exact in bf16
            mask_t = mk.reshape(leaf.shape).to(leaf.dtype)
            sel = [a] if lanes is None else list(a)
            parts = []
            for x, mt, ow, a_l in zip(leaf.chunk(len(sel)), mask_t.chunk(len(sel)),
                                      own.chunk(len(sel)), sel):
                a_t = a_l.to(leaf.dtype).float()
                agg = torch.einsum("j...,ji->i...", (x * mt).float(), a_t)
                cnt = torch.einsum("j...,ji->i...", mt.float(), a_t)
                parts.append(_count_average(agg, cnt, ow))
            out.append(parts[0] if lanes is None else torch.cat(parts))
    return tree_unflatten(treedef, out)


def _padded_leaf(nbrs, sel_f, leaf, own, p_i, mode, mk, gens, pad, impl):
    m = nbrs.shape[0]
    if mode == "exact":
        flat = leaf.reshape(m, -1)
        n = flat.shape[1]
        if mk is None:
            mk = _draw_masks(gens, (m, n), p_i, mode)
        mk = mk.reshape(m, n)
        payload = torch.where(mk, flat, 0).float()
    else:
        flat = leaf
        if mk is None:
            mk = _draw_masks(gens, tuple(leaf.shape), p_i, mode)
        mk = mk.reshape(leaf.shape)
        payload = (flat * mk.to(flat.dtype)).float()
    mask_f = mk.float()
    del mk
    agg, cnt = gather_terms(
        nbrs, [(sel_f, payload), (sel_f, mask_f)], pad=pad, impl=impl
    )
    del payload, mask_f
    fallback = flat if own is None else own.reshape(flat.shape)
    return _count_average(agg, cnt, fallback).reshape(leaf.shape)


def pme_average_pytree_padded(
    key,                      # int, or one key per lane (int64 ndarray [L])
    params,                   # pytree with [m, ...] leaves
    nbrs: torch.Tensor,       # [m, d] padded neighbour ids
    sel: torch.Tensor,        # [m, d] bool — sample_neighbor_selection_padded
    p,                        # float, or per-leaf rate sequence
    mode: str = "bernoulli",
    pad: Optional[torch.Tensor] = None,  # [m, d] bool — structural padding
    impl: Optional[str] = None,          # gossip contraction (core.mixing)
    self_params=None,
    *,
    masks: Optional[Sequence[torch.Tensor]] = None,  # per-leaf draws, JAX order
):
    """PME applied leaf-wise through the padded neighbour-exchange form.

    Same estimator as `pme_average_pytree` with a dense selection matrix,
    but the node-axis contraction runs through `core.mixing.gather_terms`
    over the d slots: the payload sum and the lambda_{i,l} counts ride one
    slot walk (two terms sharing the selection table), in f32, and the
    average is cast back to the leaf's type.  Each leaf's f32 transients
    are dropped before the next leaf is drawn.  L lanes ride one call: the
    leaves' L·m rows, a lane-offset table (`core.mixing.fold_padded`'s
    layout) and one key a lane, so each leaf is one walk for all lanes.
    """
    leaves, treedef = tree_flatten(params)
    self_leaves = [None] * len(leaves) if self_params is None else tree_flatten(self_params)[0]
    sel_f = sel.float()
    per_leaf = isinstance(p, (tuple, list))
    out = []
    for idx, leaf in enumerate(leaves):
        mk, gens = _leaf_masks(masks, idx, key, leaf.device)
        out.append(_padded_leaf(
            nbrs, sel_f, leaf, self_leaves[idx], p[idx] if per_leaf else p,
            mode, mk, gens, pad, impl,
        ))
    return tree_unflatten(treedef, out)


def message_bits(s: int, n: int, value_bits: int = 64) -> int:
    """Eq. (8): a sparse vector costs (value_bits-1)*s + n bits (s payload
    values + an n-bit occupancy pattern); 64-bit gives 63s + n.  value_bits=8
    is the int8 wire format: 8-bit values, the pattern and one f32 scale."""
    if value_bits == 8:
        return 8 * s + n + 32
    return (value_bits - 1) * s + n


def leaf_rates(num_leaves: int, p: float, p_leaf=None) -> Tuple[float, ...]:
    """Per-leaf transmission rates of a tree-partitioned message: ``p_leaf``
    lists one rate in (0, 1] per leaf in JAX leaf order, None broadcasts p."""
    if p_leaf is None:
        rates = (float(p),) * num_leaves
    else:
        rates = tuple(float(r) for r in p_leaf)
        if len(rates) != num_leaves:
            raise ValueError(
                f"p_leaf has {len(rates)} rates but the model pytree has "
                f"{num_leaves} leaves"
            )
    for r in rates:
        if not 0.0 < r <= 1.0:
            raise ValueError(f"per-leaf transmission rate {r} outside (0, 1]")
    return rates


def tree_message_bits(sizes, rates, value_bits: int = 64) -> int:
    """Eq. (8) cost of one tree-partitioned message: each leaf of n_leaf
    coordinates at rate r carries s_leaf = max(1, round(r·n_leaf)) values
    and its own n_leaf-bit occupancy pattern."""
    if isinstance(rates, float):
        rates = (rates,) * len(sizes)
    if len(rates) != len(sizes):
        raise ValueError(f"got {len(rates)} rates for {len(sizes)} leaf sizes")
    return sum(
        message_bits(max(1, int(round(r * n))), int(n), value_bits)
        for r, n in zip(rates, sizes)
    )
