"""Gossip mixing operators in dense and padded form (port of
`repro.core.mixing`).

Every baseline applies the doubly-stochastic matrix B of Assumption 1 to
node-stacked pytrees, out_i = sum_j B_ji x_j, through a `Mixer`; the
padded modes and PaME's sparse partial exchange
(`repro_torch.core.pme.pme_average_pytree_padded`) route through one
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

Three `Mixer` modes, as in JAX:

  * "sparse" — padded gather over N_i ∪ {i} (O(m·deg·n)); the registry's
    default.  On CUDA tensors it runs through the gossip kernel, in the
    leaf's type (f32 or bf16).
  * "dense"  — the same padded gather over the full [m, m] connectivity
    (non-edges weigh exactly 0.0), bit-identical to "sparse" under
    impl="slots" and impl="kernel".
  * "matrix" — the plain `torch.einsum("ji,j...->i...")` of B, what a raw
    [m, m] tensor becomes through `as_mixer`.

Lanes (`core.lanes`): `make_mixer(..., lanes=L)` builds a mixer over L
copies of the graph folded into L·m rows.  `fold_padded` offsets every
slot of lane l's rows by l·m, padding slots included, so a padding slot
repeats the receiver's own row in its own lane and a weight of 0.0 never
multiplies another lane's value (a NaN in one lane stays there).  The
tables are built once, with the mixer, and one launch a leaf covers all
lanes.  The "matrix" mode contracts lane by lane with the [m, m] matrix;
it never builds a block-diagonal [L·m, L·m] one.

Two helpers serve the temporal and fault paths:

  * `ring_gather` — each node's value from the staleness ring where it is
    delayed, its fresh value elsewhere (JAX's form: a new tree; the
    registry's bound steps move only the delayed rows instead, see
    `core.algorithms`);
  * `mix_replicated` — each receiver mixes the copies it holds of its
    neighbours' surrogates, out_i = Σ_s w_off[i, s]·held[i, s] +
    self_w[i]·held[i, d].  A held leaf [m, d + 1, ...] is receiver i's d
    replicas and then its own value, the layout the fault steps keep as
    their state; viewed as m·(d + 1) sender rows it is contracted by
    `gather_terms` over `replica_table`: the gossip kernel on the card.
"""
from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core import lanes as LN
from repro_torch.tree import tree_map

__all__ = [
    "PaddedMixing", "Mixer", "mix_padded", "make_mixer", "as_mixer",
    "gather_terms", "default_impl", "env_impl", "IMPLS", "ENV_VAR",
    "ring_gather", "mix_replicated", "replica_table", "fold_padded",
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

    @property
    def m(self) -> int:
        return self.nbrs.shape[0]

    @property
    def self_weight(self) -> torch.Tensor:
        """[m] — the diagonal B_ii, recovered from the self slot."""
        return torch.where(self.is_self, self.w, torch.zeros_like(self.w)).sum(dim=1)

    def with_weights(self, w: torch.Tensor) -> "PaddedMixing":
        return PaddedMixing(self.nbrs, w, self.is_self, self.pad)


def fold_padded(pm: PaddedMixing, lanes: int) -> PaddedMixing:
    """L copies of `pm` as one [L·m, k] table: lane l's rows index rows
    l·m ... l·m + m − 1 in every slot (padding slots too), so no lane
    reads another's rows."""
    if lanes == 1:
        return pm
    rep = lambda t: None if t is None else t.repeat(lanes, 1)  # noqa: E731
    return PaddedMixing(LN.offset_rows([pm.nbrs] * lanes), rep(pm.w), rep(pm.is_self),
                        rep(pm.pad))


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
    terms: Sequence[Tuple[torch.Tensor, torch.Tensor]],   # ([m, k] w, [M, ...] x)
    *,
    pad: Optional[torch.Tensor] = None,                   # [m, k] padding slots
    impl: Optional[str] = None,
) -> Tuple[torch.Tensor, ...]:
    """One-pass neighbour contraction shared by every padded gossip path:
    for each (w, x) term, out_i = sum_slot w[i, slot] · x[nbrs[i, slot]],
    [m, ...] out of the M >= m sender rows of x.  `impl=None` resolves
    through `default_impl` for the tensors' device."""
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


def ring_gather(ring, fresh, slot: torch.Tensor, use_ring: torch.Tensor):
    """Per-sender delayed gather: node j's value is ``ring[slot[j], j]``
    where ``use_ring[j]``, else ``fresh[j]`` (ring leaves [D, m, ...],
    fresh leaves [m, ...]); a new tree."""
    m = slot.shape[0]

    def one(r, f):
        node = torch.arange(m, device=r.device)
        keep = use_ring.to(f.device).reshape((m,) + (1,) * (f.dim() - 1))
        return torch.where(keep, r[slot.to(r.device).long(), node], f)

    return tree_map(one, ring, fresh)


def replica_table(m: int, d: int, device=None) -> torch.Tensor:
    """[m, d + 1] table into the m·(d + 1) sender rows of a held leaf:
    receiver i's d replicas, then its own value (rows i·(d + 1) + s)."""
    return torch.arange(m * (d + 1), device=device).view(m, d + 1).to(torch.int32)


def mix_replicated(w_off: torch.Tensor, self_w: torch.Tensor, held,
                   impl: Optional[str] = None):
    """out_i = Σ_s w_off[i, s]·held[i, s] + self_w[i]·held[i, d] for every
    held leaf [m, d + 1, ...] (receiver i's replicas, then its own value):
    each receiver mixes the copies it holds, with no cross-node gather.
    The slots are summed in order, replicas first, through `gather_terms`
    (`impl` as there); padding replicas weigh exactly 0.  A leaf must be
    contiguous: it is read in place as m·(d + 1) sender rows."""

    def one(h):
        m, d1 = h.shape[:2]
        w = torch.cat([w_off.reshape(m, d1 - 1), self_w.reshape(m, 1)], dim=1).to(
            h.device, torch.float32)
        rows = h.view((m * d1,) + tuple(h.shape[2:]))
        return gather_terms(replica_table(m, d1 - 1, h.device), [(w, rows)], impl=impl)[0]

    return tree_map(one, held)


def _dense_padded(bmat: torch.Tensor) -> PaddedMixing:
    """Full-connectivity padded form: every sender is a slot (ascending)."""
    m = bmat.shape[0]
    nbrs = torch.arange(m, dtype=torch.int32, device=bmat.device)[None, :].repeat(m, 1)
    w = bmat.T.to(torch.float32).contiguous()  # w[i, j] = B[j, i]
    is_self = torch.eye(m, dtype=torch.bool, device=bmat.device)
    return PaddedMixing(nbrs, w, is_self)


def _einsum(mat: torch.Tensor, x: torch.Tensor, lanes: int = 1) -> torch.Tensor:
    """out_i = sum_j mat_ji x_j in x's type; with lanes, each lane's m rows
    by the [m, m] `mat` on their own."""
    if lanes == 1:
        return torch.einsum("ji,j...->i...", mat.to(x.dtype), x)
    return torch.cat([_einsum(mat, xl) for xl in x.chunk(lanes)])


@dataclasses.dataclass(frozen=True)
class Mixer:
    """Gossip operator with interchangeable dense / sparse implementations.

    `b` is the dense [m, m] matrix (reference and wire accounting), `pm` the
    padded form the "dense" / "sparse" modes gather over, and `impl` the
    neighbour contraction ("slots" | "segsum" | "kernel" | None =
    `default_impl` for the tensors' device).  Every method takes a pytree
    of [m, ...] leaves, or one leaf, and returns fresh tensors.  With
    ``lanes=L`` the leaves are [L·m, ...] and `pm` is the folded table
    (`fold_padded`).
    """

    mode: str                        # "matrix" | "dense" | "sparse"
    b: Optional[torch.Tensor]        # [m, m]
    pm: Optional[PaddedMixing] = None
    impl: Optional[str] = None
    lanes: int = 1

    @property
    def m(self) -> int:
        return self.pm.m if self.b is None else self.b.shape[0]

    def _eye(self) -> torch.Tensor:
        return torch.eye(self.m, dtype=self.b.dtype, device=self.b.device)

    def mix(self, tree):
        """out_i = sum_j B_ji x_j."""
        if self.mode == "matrix":
            return tree_map(lambda x: _einsum(self.b, x, self.lanes), tree)
        return mix_padded(self.pm, tree, impl=self.impl)

    def mix_lazy(self, tree):
        """(B − I) x — the gossip increment used by BEER."""
        if self.mode == "matrix":
            w = self.b - self._eye()
            return tree_map(lambda x: _einsum(w, x, self.lanes), tree)
        return tree_map(lambda mx, x: mx - x, mix_padded(self.pm, tree, impl=self.impl), tree)

    def mix_half(self, tree):
        """((I + B)/2) x — the NIDS averaging operator Ã."""
        if self.mode == "matrix":
            a_tilde = 0.5 * (self._eye() + self.b)
            return tree_map(lambda x: _einsum(a_tilde, x, self.lanes), tree)
        return tree_map(lambda mx, x: (0.5 * (mx + x)).to(x.dtype),
                        mix_padded(self.pm, tree, impl=self.impl), tree)

    def mix_nids_quantized(self, hats, u):
        """off(Ã)·hats + diag(Ã)·u, Ã = (I+B)/2 — quantized NIDS mixing,
        where each node keeps its own exact copy u_i and only off-diagonal
        traffic moves through the lossy surrogates."""
        if self.mode == "matrix":
            a_tilde = 0.5 * (self._eye() + self.b)
            diag = torch.diagonal(a_tilde)
            off = a_tilde - torch.diag(diag)
            diag = diag.repeat(self.lanes)
            return tree_map(lambda uh, ue: _einsum(off, uh, self.lanes) + ue * _bcast(diag, ue),
                            hats, u)
        sw = self.pm.self_weight  # B_ii
        half_diag = 0.5 * (1.0 + sw)

        def one(mx, h, ue):
            return (0.5 * (mx - _bcast(sw, h) * h) + _bcast(half_diag, ue) * ue).to(ue.dtype)

        return tree_map(one, mix_padded(self.pm, hats, impl=self.impl), hats, u)


def make_mixer(topo, mode: str = "sparse", impl: Optional[str] = None,
               device=None, lanes: int = 1) -> Mixer:
    """Build a Mixer from a `repro_torch.core.topology.Topology` on `device`
    (default CPU).

    mode="sparse" gathers over N_i ∪ {i}; mode="dense" runs the same gather
    over full connectivity; mode="matrix" is the plain einsum.  `impl`
    picks the neighbour contraction (None = `default_impl` per call).
    ``lanes=L`` mixes L lanes folded into [L·m, ...] leaves (`fold_padded`).
    """
    if impl is not None:
        _check_impl(impl)
    b = torch.as_tensor(topo.mixing, dtype=torch.float32, device=device)
    if mode == "matrix":
        return Mixer("matrix", b, lanes=lanes)
    if mode == "dense":
        return Mixer("dense", b, fold_padded(_dense_padded(b), lanes), impl, lanes)
    if mode != "sparse":
        raise ValueError(f"unknown mixing mode {mode!r}")
    nbrs, w, is_self = (torch.as_tensor(v, device=device) for v in topo.mixing_padded())
    nbrs = nbrs.to(torch.int32)
    # padding slots repeat the row's own id without being the self slot
    pad = (nbrs == torch.arange(nbrs.shape[0], device=nbrs.device)[:, None]) & ~is_self
    pm = PaddedMixing(nbrs, w.to(torch.float32), is_self, pad)
    return Mixer("sparse", b, fold_padded(pm, lanes), impl, lanes)


def as_mixer(b: Union[Mixer, torch.Tensor]) -> Mixer:
    """Normalize a step-function operand: a raw [m, m] tensor keeps the
    plain einsum semantics; Mixer instances pass through."""
    if isinstance(b, Mixer):
        return b
    return Mixer("matrix", b)
