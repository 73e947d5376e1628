"""Message-level fault injection with per-receiver surrogate replicas
(port of `repro.core.faults`).

The scenario layer models a down link as a symmetric edge removal both
ends know about.  Real networks fail per message: per direction, in
bursts, late, or because the sender crashed; and surrogate-memory
algorithms desync through exactly those losses.  This module:

  * `FaultModel`     — i.i.d. per-direction message loss, a
                       Gilbert–Elliott lossy-link chain per *directed*
                       slot, delayed delivery (message-only, through the
                       staleness ring) and transient node crashes with
                       geometric rejoin.
  * `advance_faults` — one transition over the base scenario's masks:
                       crashes fold into `alive` before the weights are
                       built, losses are drawn per directed slot, and the
                       kept off-diagonal weights are renormalized into the
                       self slot per receiver (rows sum to exactly 1), with
                       the column-sum defect — the step's drift of the
                       global mean — returned and accumulated.
  * `rep_*_init/step` — CHOCO-SGD, BEER and ANQ-NIDS with per-receiver
                       surrogate replicas [m, d, ...]: a lost innovation
                       desyncs the receiver's copy; with `repair` the
                       sender retransmits its full surrogate on the next
                       realized link, charged at the uncompressed Eq.-(8)
                       rate.

PaME needs no replicas: its count-normalized average is memoryless, so a
lost message only shrinks λ_{i,l}.

As in `core.scenarios`, the fault state and realizations are CPU tensors
and the per-step delivery decisions are made on the host: a delivered
innovation is added to its replica row in place, a repair copies the
sender's row, and nothing else of the replica tree is touched or copied.
CHOCO and BEER keep each stream's replicas and sender surrogates as one
held leaf [m, d + 1, ...] (receiver i's d replicas, then its own
surrogate): the state's own tensor, which `mix_replicated` contracts
through the gossip kernel in place; the states' `hats` / `reps` (`h`,
`h_reps`, `z`, `z_reps`) are views of it, JAX's fields.

Lanes (`core.lanes`): each lane advances its own fault chain from its own
key (`advance_faults` on its base arrays), `fold_realizations` stacks the
lanes' outcomes over L·m rows, and the `rep_*` steps run on a folded
state over folded arrays (`core.scenarios.fold_arrays`): a held leaf
[L·m, d + 1, ...] is read as L·m·(d + 1) sender rows, so lane l's block
starts at row l·m·(d + 1) and one gossip launch a leaf mixes every lane's
replicas; the wire, repair and desync metrics come back [L].

Randomness: JAX splits fold_in(key, k) four ways (loss, burst, crash,
delay); the port draws from `fold_in(fold_in(seed, k), tag)` with tags 0–3
in those roles and its stationary link draw from the JAX fold constant.
`advance_faults` takes the uniforms instead (``u={"loss": [m, d], "burst":
[m, d], "crash": [m], "delay": [m]}``), `fault_state_init` ``u={"link":
[m, d]}``, and the `rep_*` steps their compression draws (``draws=``, JAX's
tags: CHOCO 7, BEER 3 and 5, NIDS 11).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import baselines as B
from repro_torch.core import lanes as LN
from repro_torch.core.compression import Compressor
from repro_torch.core.mixing import mix_replicated
from repro_torch.core.pme import fold_in, message_bits
from repro_torch.core import scenarios as scen_mod
from repro_torch.core.scenarios import (
    Realization,
    ScenarioArrays,
    _uniform,
    realization_from_masks,
    realization_matrix,
)
from repro_torch.core.temporal import ring_init
from repro_torch.tree import tree_flatten, tree_leaves, tree_map

__all__ = [
    "FaultModel",
    "FaultState",
    "FaultCarry",
    "FaultRealization",
    "FAULT_PRESETS",
    "get_fault_model",
    "list_fault_models",
    "fault_state_init",
    "fault_carry_init",
    "advance_faults",
    "fold_realizations",
    "fault_matrix",
    "RepChocoState", "rep_choco_init", "rep_choco_step",
    "RepBeerState", "rep_beer_init", "rep_beer_step",
    "RepNidsState", "rep_nids_init", "rep_nids_step",
]

# seed fold of the stationary link-chain draw (the JAX package's constant)
_INIT_LINK_FOLD = 0x7FFFFFFB
# fold_in tags of the four per-step draws
_LOSS, _BURST, _CRASH, _DELAY = 0, 1, 2, 3


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Message-level failure spec; zero-rate branches are skipped, so an
    `is_static` model binds the fault-free program."""

    name: str = "faults"
    loss: float = 0.0        # P[a directed message is dropped]
    burst_down: float = 0.0  # P[good -> lossy] per step
    burst_up: float = 0.5    # P[lossy -> good] per step
    loss_bad: float = 1.0    # P[dropped | link lossy]
    delay: float = 0.0       # P[a node's outgoing messages are late]
    max_delay: int = 0       # D: past it the messages are dropped (0 = off)
    crash: float = 0.0       # P[up -> crashed] per step
    rejoin: float = 0.5      # P[crashed -> recovered] per step
    repair: bool = True      # resync desynced replicas, wire-charged
    seed: int = 0

    def __post_init__(self):
        for field in ("loss", "burst_down", "burst_up", "loss_bad",
                      "delay", "crash", "rejoin"):
            v = getattr(self, field)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{field}={v} must be a probability in [0, 1]")
        if self.max_delay < 0:
            raise ValueError(f"max_delay={self.max_delay} must be >= 0")
        if self.delay > 0.0 and self.max_delay == 0:
            raise ValueError("delay>0 needs max_delay>=1 (the staleness ring bound)")
        if self.burst_down > 0.0 and self.burst_up == 0.0:
            raise ValueError("burst_up=0 would make lossy links permanent")
        if self.crash > 0.0 and self.rejoin == 0.0:
            raise ValueError("rejoin=0 would make crashes permanent")

    @property
    def is_static(self) -> bool:
        """True iff no fault can ever fire."""
        return self.loss == self.burst_down == self.delay == self.crash == 0.0

    @property
    def stationary_lossy(self) -> float:
        """Stationary P[link lossy] of the Gilbert–Elliott chain."""
        denom = self.burst_down + self.burst_up
        return self.burst_down / denom if denom > 0.0 else 0.0


FAULT_PRESETS = {
    "lossy": FaultModel(name="lossy", loss=0.1),
    "bursty_loss": FaultModel(name="bursty_loss", burst_down=0.05, burst_up=0.25),
    "crashy": FaultModel(name="crashy", crash=0.02, rejoin=0.2),
    "late": FaultModel(name="late", delay=0.3, max_delay=3),
    "harsh_faults": FaultModel(
        name="harsh_faults", loss=0.1, burst_down=0.05, burst_up=0.3,
        crash=0.02, rejoin=0.25, delay=0.2, max_delay=2),
}


def get_fault_model(name: str) -> FaultModel:
    if name not in FAULT_PRESETS:
        raise ValueError(f"unknown fault model {name!r}; pick from {sorted(FAULT_PRESETS)}")
    return FAULT_PRESETS[name]


def list_fault_models() -> Tuple[str, ...]:
    return tuple(FAULT_PRESETS)


class FaultState(NamedTuple):
    """Fault Markov state carried from step to step (CPU tensors)."""

    link_bad: torch.Tensor  # [m, d] bool — lossy state per directed slot
    crashed: torch.Tensor   # [m] bool
    age: torch.Tensor       # [m] int32 — consecutive late-delivery count
    drift: torch.Tensor     # f32 scalar — cumulative column-sum defect


class FaultCarry(NamedTuple):
    """Auxiliary carry of a faulty run: the fault state and the
    delayed-delivery ring (None when max_delay == 0)."""

    fs: FaultState
    ring: Optional[object]


class FaultRealization(NamedTuple):
    """One step's message-level outcome over the base realization."""

    base: Realization           # crash-aware scenario realization (symmetric)
    recv_ok: torch.Tensor       # [m, d] bool — directed messages delivered
    weights: torch.Tensor       # [m, d+1] f32 — per-receiver renormalized
    delayed: torch.Tensor       # [m] bool — senders served from the ring
    tau: torch.Tensor           # [m] int32 — current delay per sender
    dropped: torch.Tensor       # int32 — realized directed messages lost
    col_defect: torch.Tensor    # f32 — Σ_j |colsum_j − 1|


def fault_state_init(model: FaultModel, arrays: ScenarioArrays, key: int, *,
                     u: Optional[dict] = None) -> FaultState:
    """The link chain from its stationary law; nodes start healthy and
    punctual."""
    m, d = arrays.nbrs.shape
    link_bad = torch.zeros((m, d), dtype=torch.bool)
    if model.burst_down > 0.0:
        link_bad = _uniform(u, "link", fold_in(key, _INIT_LINK_FOLD), (m, d)) < model.stationary_lossy
    return FaultState(link_bad=link_bad, crashed=torch.zeros(m, dtype=torch.bool),
                      age=torch.zeros(m, dtype=torch.int32),
                      drift=torch.zeros((), dtype=torch.float32))


def fault_carry_init(model: FaultModel, arrays: ScenarioArrays, params_stacked, key: int,
                     *, u: Optional[dict] = None) -> FaultCarry:
    return FaultCarry(fs=fault_state_init(model, arrays, key, u=u),
                      ring=ring_init(params_stacked, model.max_delay))


def advance_faults(model: FaultModel, arrays: ScenarioArrays, fs: FaultState, key: int,
                   k: int, edge_up: torch.Tensor, alive: torch.Tensor,
                   straggler: torch.Tensor, *, u: Optional[dict] = None
                   ) -> Tuple[FaultState, FaultRealization]:
    """One fault transition and step k's message-level realization over
    the base scenario's masks (`scenarios.sample_masks`)."""
    m, d = arrays.nbrs.shape
    kk = fold_in(key, int(k))
    alive = alive.cpu().bool()

    link_bad = fs.link_bad
    if model.burst_down > 0.0:
        x = _uniform(u, "burst", fold_in(kk, _BURST), (m, d))
        link_bad = torch.where(fs.link_bad, x < 1.0 - model.burst_up, x < model.burst_down)
    crashed = fs.crashed
    if model.crash > 0.0:
        x = _uniform(u, "crash", fold_in(kk, _CRASH), (m,))
        crashed = torch.where(fs.crashed, x < 1.0 - model.rejoin, x < model.crash)
    late = torch.zeros(m, dtype=torch.bool)
    if model.delay > 0.0:
        late = _uniform(u, "delay", fold_in(kk, _DELAY), (m,)) < model.delay
    age = torch.where(late, fs.age + 1, torch.zeros_like(fs.age))
    delayed = late & alive & ~crashed & (age <= model.max_delay)
    overdue = late & ~delayed  # past the bound: messages dropped outright

    r = realization_from_masks(arrays, edge_up, alive & ~crashed, straggler)

    lost = torch.zeros((m, d), dtype=torch.bool)
    if model.loss > 0.0 or model.burst_down > 0.0:
        p_drop = torch.where(link_bad, model.loss_bad, model.loss).to(torch.float32)
        lost = _uniform(u, "loss", fold_in(kk, _LOSS), (m, d)) < p_drop
    recv_ok = r.edge_alive & ~lost & ~overdue[arrays.nbrs.cpu()]

    # per-receiver renormalization: lost mass folds into the self slot
    w_off = torch.where(recv_ok, r.weights[:, :d], torch.zeros((), dtype=torch.float32))
    acc = w_off[:, 0].clone()
    for s in range(1, d):
        acc = acc + w_off[:, s]
    weights = torch.cat([w_off, (1.0 - acc)[:, None]], dim=1)

    # the matrix is row- but not column-stochastic: the column-sum defect
    # is the step's leak of the global mean under direct mixing
    col = torch.zeros(m, dtype=torch.float32).index_add_(
        0, arrays.nbrs_full.cpu().reshape(-1), weights.reshape(-1))
    col_defect = torch.sum(torch.abs(col - 1.0))

    new_fs = FaultState(link_bad=link_bad, crashed=crashed, age=age,
                        drift=fs.drift + col_defect)
    fr = FaultRealization(
        base=r, recv_ok=recv_ok, weights=weights, delayed=delayed,
        tau=torch.where(delayed, age, torch.zeros_like(age)),
        dropped=(r.edge_alive & ~recv_ok).sum().to(torch.int32),
        col_defect=col_defect,
    )
    return new_fs, fr


def fold_realizations(frs) -> FaultRealization:
    """L lanes' outcomes over their L·m rows: the base realizations folded
    (`scenarios.fold_realizations`), the per-row masks, weights and delays
    concatenated, ``dropped`` and ``col_defect`` [L]."""
    return FaultRealization(
        base=scen_mod.fold_realizations([fr.base for fr in frs]),
        **{f: torch.cat([getattr(fr, f) for fr in frs])
           for f in ("recv_ok", "weights", "delayed", "tau")},
        **{f: torch.stack([getattr(fr, f) for fr in frs]) for f in ("dropped", "col_defect")})


def fault_matrix(arrays: ScenarioArrays, fr: FaultRealization) -> torch.Tensor:
    """The faulted [m, m] matrix (row i = receiver i): row-stochastic,
    column-defective by the lost mass."""
    return realization_matrix(arrays, fr.base._replace(weights=fr.weights))


# ---------------------------------------------------------------------------
# Per-receiver surrogate replicas for the compressed baselines
# ---------------------------------------------------------------------------
def _held_zeros(params_stacked, d: int):
    """A zero held tree: per leaf [m, d + 1, ...], receiver i's d replicas
    then its own surrogate (see `mixing.mix_replicated`)."""
    return tree_map(lambda x: torch.zeros((x.shape[0], d + 1) + tuple(x.shape[1:]),
                                          dtype=x.dtype, device=x.device), params_stacked)


def _own(held):
    """The senders' own surrogates [m, ...]: views of a held tree."""
    return tree_map(lambda h: h[:, -1], held)


def _replicas(held):
    """The receivers' replicas [m, d, ...]: views of a held tree."""
    return tree_map(lambda h: h[:, :-1], held)


def _links(arrays: ScenarioArrays, mask: torch.Tensor):
    """(receiver, slot, sender) of every slot where `mask` is True."""
    nbrs = arrays.nbrs.cpu()
    return [(int(i), int(s), int(nbrs[i, s])) for i, s in torch.nonzero(mask.cpu()).tolist()]


def _deliver_stream(rep: torch.Tensor, q: torch.Tensor, own_new: torch.Tensor,
                    arrays: ScenarioArrays, recv_ok: torch.Tensor,
                    pending: torch.Tensor, repair: bool) -> None:
    """One delivery round of one stream, on one leaf, in place: a
    delivered innovation on a synced link adds q_sender to the replica; a
    delivered message on a pending link (with `repair`) is the sender's
    full surrogate and overwrites it; lost or unrealized, untouched."""
    fixed = (recv_ok & pending) if repair else torch.zeros_like(recv_ok)
    for i, s, j in _links(arrays, recv_ok & ~fixed):
        rep[i, s].add_(q[j])
    for i, s, j in _links(arrays, fixed):
        rep[i, s].copy_(own_new[j])


def _desync(arrays: ScenarioArrays, reps, own, lanes: Optional[int] = None) -> torch.Tensor:
    """Σ over real base links of ||replica − sender's surrogate||²; [L]
    over folded arrays, each lane's links summed in its unbatched order."""
    m = arrays.m // (lanes or 1)
    tots = [torch.zeros((), dtype=torch.float32)] * (lanes or 1)
    links = _links(arrays, arrays.valid)
    for rep, o in zip(tree_leaves(reps), tree_leaves(own)):
        tots = [t.to(rep.device) for t in tots]
        for i, s, j in links:
            tots[i // m] = tots[i // m] + torch.sum((rep[i, s] - o[j]).to(torch.float32) ** 2)
    return tots[0] if lanes is None else torch.stack(tots)


def _n_total(params_stacked) -> int:
    return sum(int(np.prod(tuple(x.shape[1:]))) for x in tree_leaves(params_stacked))


def _link_traffic(arrays: ScenarioArrays, fr: FaultRealization, pending: torch.Tensor,
                  repair: bool, innov_bits: float, repair_streams: int, n: int,
                  lanes: Optional[int] = None):
    """(wire_bits, repair_bits, new pending): innovations charged on every
    realized non-pending directed link (lost or not), one full Eq.-(8)
    message per stream on every realized pending link; afterwards pending
    is every real base link that did not deliver this round.  The bits
    are [L] over folded arrays."""
    ea = fr.base.edge_alive

    def count(mask):
        return (mask.sum() if lanes is None
                else mask.reshape(lanes, -1).sum(dim=1)).to(torch.float32)

    full = float(message_bits(n, n, 64)) * float(repair_streams)
    if repair:
        n_repair = count(pending & ea)
        n_normal = count(ea & ~pending)
        new_pending = arrays.valid.cpu() & ~fr.recv_ok
        repair_bits = full * n_repair
    else:
        n_normal = count(ea)
        new_pending = pending
        repair_bits = torch.zeros(() if lanes is None else (lanes,), dtype=torch.float32)
    return float(innov_bits) * n_normal + repair_bits, repair_bits, new_pending


def _weights(fr: FaultRealization, d: int, device):
    w = fr.base.weights.to(device)
    return w[:, :d], w[:, d]


# -- CHOCO-SGD with per-receiver replicas -----------------------------------
class RepChocoState(NamedTuple):
    params: object    # x_i
    held: object      # [m, d + 1, ...] receiver i's copies of \hat x_{nbrs[i, s]}, then \hat x_i
    pending: torch.Tensor  # [m, d] bool — awaiting repair (CPU)
    step: int
    key: int

    @property
    def hats(self):   # \hat x_i — the sender's own surrogate
        return _own(self.held)

    @property
    def reps(self):   # [m, d, ...] receiver i's copy of \hat x_{nbrs[i, s]}
        return _replicas(self.held)


def rep_choco_init(key, params_stacked, arrays: ScenarioArrays) -> RepChocoState:
    """A fresh replicated state; a per-lane key (int64 [L]) starts L lanes
    folded over the rows of `arrays` (`scenarios.fold_arrays`)."""
    m, d = arrays.nbrs.shape
    step, key = B._start(key)
    return RepChocoState(params_stacked, _held_zeros(params_stacked, d),
                         torch.zeros((m, d), dtype=torch.bool), step, key)


def rep_choco_step(state: RepChocoState, batch, grad_fn, lr: float, comp: Compressor,
                   gossip_gamma: float, fr: FaultRealization, arrays: ScenarioArrays,
                   innov_bits: float, repair: bool, grad_shift=None, *,
                   draws=None) -> Tuple[RepChocoState, dict]:
    """CHOCO-SGD where each receiver mixes the surrogate copies it holds,
    under the symmetric realized weights: loss shows as replica desync.
    In place, leaf by leaf: x ← x − lr·g (node by node); q = C(x − x̂);
    x̂ += q; deliver q to the replicas; x += γ(mix(replicas, x̂) − x̂).
    ``draws={"q": [...]}`` (JAX tag 7)."""
    d = arrays.nbrs.shape[1]
    lanes = LN.count(state.key)
    key = LN.fold(state.key, state.step)
    xs, treedef = tree_flatten(state.params)
    held = tree_leaves(state.held)
    losses = B._grads_inplace(grad_fn, xs, treedef, batch, key, lr,
                              B._as_shift(grad_shift, len(xs)))
    w_off, self_w = _weights(fr, d, xs[0].device)
    k_q = LN.fold(key, 7)
    with torch.no_grad():
        for idx, (x, hr) in enumerate(zip(xs, held)):
            h = hr[:, -1]
            q = B._compressed_diff(comp, k_q, idx, x, h, B._draw(draws, "q", idx))
            h.add_(q)
            _deliver_stream(hr[:, :-1], q, h, arrays, fr.recv_ok, state.pending, repair)
            del q
            mixed = mix_replicated(w_off, self_w, hr)
            x.add_(LN.scale_(mixed.sub_(h), gossip_gamma, key))
            del mixed
    wire_bits, repair_bits, pending = _link_traffic(
        arrays, fr, state.pending, repair, innov_bits, 1, _n_total(state.params), lanes)
    metrics = {
        "loss_mean": B._mean(losses, key),
        "wire_bits": wire_bits,
        "repair_bits": repair_bits,
        "surrogate_desync": _desync(arrays, state.reps, state.hats, lanes),
    }
    return (RepChocoState(state.params, state.held, pending, state.step + 1, state.key),
            metrics)


# -- BEER with per-receiver replicas ----------------------------------------
class RepBeerState(NamedTuple):
    params: object     # x
    h_held: object     # [m, d + 1, ...] replicas of h[nbrs], then h
    g: object          # gradient tracker
    z_held: object     # [m, d + 1, ...] replicas of z[nbrs], then z
    prev_grad: object
    pending: torch.Tensor  # [m, d] bool (both streams ride one message)
    step: int
    key: int

    @property
    def h(self):       # surrogate of x (sender truth)
        return _own(self.h_held)

    @property
    def z(self):       # surrogate of g (sender truth)
        return _own(self.z_held)

    @property
    def h_reps(self):  # [m, d, ...] replicas of h[nbrs]
        return _replicas(self.h_held)

    @property
    def z_reps(self):  # [m, d, ...] replicas of z[nbrs]
        return _replicas(self.z_held)


def rep_beer_init(key, params_stacked, batch0, grad_fn,
                  arrays: ScenarioArrays) -> RepBeerState:
    m, d = arrays.nbrs.shape
    step, key = B._start(key)
    g0 = B._stacked_grads(grad_fn, params_stacked, batch0, key)
    return RepBeerState(params_stacked, _held_zeros(params_stacked, d), g0,
                        _held_zeros(params_stacked, d), tree_map(torch.clone, g0),
                        torch.zeros((m, d), dtype=torch.bool), step, key)


def rep_beer_step(state: RepBeerState, batch, grad_fn, lr: float, comp: Compressor,
                  gossip_gamma: float, fr: FaultRealization, arrays: ScenarioArrays,
                  innov_bits: float, repair: bool, grad_shift=None, *,
                  draws=None) -> Tuple[RepBeerState, dict]:
    """BEER with receiver-held h / z replicas, mixing the old replicas (the
    pre-update surrogates, as classic BEER).  In place, in `beer_step`'s
    order: per leaf x += γ(mix(h_reps, h) − h) − lr·g, qh = C(x − h),
    h += qh, deliver qh; per leaf g += γ(mix(z_reps, z) − z) − prev_grad;
    per node the gradient at the new x (+ shift) into g and prev_grad; per
    leaf qz = C(g − z), z += qz, deliver qz.  Both streams ride one link
    message: one pending flag, a repair sends 2 full messages.
    ``draws={"h": [...], "z": [...]}`` (JAX tags 3 and 5)."""
    d = arrays.nbrs.shape[1]
    lanes = LN.count(state.key)
    key = LN.fold(state.key, state.step)
    xs, treedef = tree_flatten(state.params)
    hhs, gs, zhs, ps = (tree_leaves(t) for t in (
        state.h_held, state.g, state.z_held, state.prev_grad))
    shift = B._as_shift(grad_shift, len(xs))
    w_off, self_w = _weights(fr, d, xs[0].device)
    k_h, k_z = LN.fold(key, 3), LN.fold(key, 5)
    with torch.no_grad():
        for idx, (x, hh, g) in enumerate(zip(xs, hhs, gs)):
            h = hh[:, -1]
            mh = mix_replicated(w_off, self_w, hh).sub_(h)
            x.add_(LN.scale_(mh, gossip_gamma, key)).sub_(LN.scaled(g, lr, key))
            del mh
            qh = B._compressed_diff(comp, k_h, idx, x, h, B._draw(draws, "h", idx))
            h.add_(qh)
            _deliver_stream(hh[:, :-1], qh, h, arrays, fr.recv_ok, state.pending, repair)
            del qh
        for zh, g, gp in zip(zhs, gs, ps):
            z = zh[:, -1]
            mz = mix_replicated(w_off, self_w, zh).sub_(z)
            g.add_(LN.scale_(mz, gossip_gamma, key)).sub_(gp)
            del mz
    losses = []
    rows, m = B._rows(xs, key)
    for i in range(rows):
        loss, gn = B._node_grad(grad_fn, B._point([x[i] for x in xs], shift, i), treedef,
                                batch, i % m, LN.node_key(key, i, m))
        losses.append(loss)
        with torch.no_grad():
            for g, gp, gi in zip(gs, ps, gn):
                g[i].add_(gi.to(g.dtype))
                gp[i].copy_(gi)
        del gn
    with torch.no_grad():
        for idx, (zh, g) in enumerate(zip(zhs, gs)):
            z = zh[:, -1]
            qz = B._compressed_diff(comp, k_z, idx, g, z, B._draw(draws, "z", idx))
            z.add_(qz)
            _deliver_stream(zh[:, :-1], qz, z, arrays, fr.recv_ok, state.pending, repair)
            del qz
    wire_bits, repair_bits, pending = _link_traffic(
        arrays, fr, state.pending, repair, innov_bits, 2, _n_total(state.params), lanes)
    desync = (_desync(arrays, state.h_reps, state.h, lanes)
              + _desync(arrays, state.z_reps, state.z, lanes))
    metrics = {"loss_mean": B._mean(losses, key), "wire_bits": wire_bits,
               "repair_bits": repair_bits, "surrogate_desync": desync}
    return (RepBeerState(state.params, state.h_held, state.g, state.z_held, state.prev_grad,
                         pending, state.step + 1, state.key), metrics)


# -- (AN)Q-NIDS with per-receiver replicas ----------------------------------
class RepNidsState(NamedTuple):
    params: object    # x^k
    c: object         # memory (own, exact)
    hat_z: object     # surrogate of z (sender truth)
    hat_c: object     # surrogate of c (sender truth)
    z_reps: object    # [m, d, ...] replicas of hat_z[nbrs]
    c_reps: object    # [m, d, ...] replicas of hat_c[nbrs]
    pending: torch.Tensor  # [m, d] bool
    step: int
    key: int


def rep_nids_init(key, params_stacked, arrays: ScenarioArrays) -> RepNidsState:
    m, d = arrays.nbrs.shape
    step, key = B._start(key)
    zeros = lambda: tree_map(torch.zeros_like, params_stacked)  # noqa: E731
    rep = lambda: tree_map(  # noqa: E731
        lambda x: torch.zeros((m, d) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device),
        params_stacked)
    return RepNidsState(params_stacked, zeros(), zeros(), zeros(), rep(), rep(),
                        torch.zeros((m, d), dtype=torch.bool), step, key)


def rep_nids_step(state: RepNidsState, batch, grad_fn, lr: float, comp: Compressor,
                  fr: FaultRealization, arrays: ScenarioArrays, innov_bits: float,
                  repair: bool, grad_shift=None, *, draws=None) -> Tuple[RepNidsState, dict]:
    """Quantized NIDS with receiver-held ẑ / ĉ replicas.  The receiver-side
    accumulation ĉ += ẑ runs on every replica (it needs no message), so a
    ẑ desync compounds into the ĉ replica; a repair resyncs both replicas
    (2 full messages), the repaired ĉ replica counting from the next step.
    In place, leaf by leaf after the node-by-node gradients (x holds z):
    v = 2z + c; q = Q(z − ẑ); ẑ += q; ĉ += ẑ; deliver q; ĥat_v = 2·z_reps
    + c_reps (old) beside v in one sender table; c_reps += z_reps, repairs
    overwrite; x = z + (mix(½w_off, ½(1 + w_ii)) − v); c += z.
    ``draws={"q": [...]}`` (JAX tag 11)."""
    m, d = arrays.nbrs.shape
    lanes = LN.count(state.key)
    key = LN.fold(state.key, state.step)
    xs, treedef = tree_flatten(state.params)
    cs, hzs, hcs, zrs, crs = (tree_leaves(t) for t in (
        state.c, state.hat_z, state.hat_c, state.z_reps, state.c_reps))
    losses = B._grads_inplace(grad_fn, xs, treedef, batch, key, lr,
                              B._as_shift(grad_shift, len(xs)))  # x holds z now
    w_off, self_w = _weights(fr, d, xs[0].device)
    w_half, self_half = 0.5 * w_off, 0.5 * (1.0 + self_w)
    fixed = _links(arrays, fr.recv_ok & state.pending) if repair else []
    k_q = LN.fold(key, 11)
    with torch.no_grad():
        for idx, (z, c, hz, hc, zr, cr) in enumerate(zip(xs, cs, hzs, hcs, zrs, crs)):
            rest = tuple(z.shape[1:])
            q = B._compressed_diff(comp, k_q, idx, z, hz, B._draw(draws, "q", idx))
            hz.add_(q)
            hc.add_(hz)
            _deliver_stream(zr, q, hz, arrays, fr.recv_ok, state.pending, repair)
            del q
            # hat_v's replicas and v as one held leaf
            held = torch.empty((m, d + 1) + rest, dtype=z.dtype, device=z.device)
            v = held[:, d]
            torch.add(2.0 * zr, cr, out=held[:, :d])
            torch.add(2.0 * z, c, out=v)
            cr.add_(zr)
            for i, s, j in fixed:
                cr[i, s].copy_(hc[j])
            corr = mix_replicated(w_half, self_half, held).sub_(v)
            del held, v
            c.add_(z)
            z.add_(corr)
            del corr
    wire_bits, repair_bits, pending = _link_traffic(
        arrays, fr, state.pending, repair, innov_bits, 2, _n_total(state.params), lanes)
    desync = (_desync(arrays, state.z_reps, state.hat_z, lanes)
              + _desync(arrays, state.c_reps, state.hat_c, lanes))
    metrics = {"loss_mean": B._mean(losses, key), "wire_bits": wire_bits,
               "repair_bits": repair_bits, "surrogate_desync": desync}
    return (RepNidsState(state.params, state.c, state.hat_z, state.hat_c, state.z_reps,
                         state.c_reps, pending, state.step + 1, state.key), metrics)
