"""Temporal dynamics: Markov network processes and bounded staleness
(port of `repro.core.temporal`).

Real networks are bursty (a bad link stays bad for a while), sessioned (a
node that leaves stays gone for a geometric time) and late rather than
absent.  This module replaces the i.i.d. draws of `core.scenarios` with
Markov chains whose state rides the engine's auxiliary carry, and adds a
bounded-staleness exchange in which a straggler keeps participating
through its τ-delayed parameters, read from a ring of the last D
parameter snapshots:

  * `TemporalScenario` — Gilbert–Elliott bursts per base edge, geometric
    node sessions, mobility resampling every `resample_every` steps, an
    i.i.d. straggler rate or a Markov straggler-session chain, and the
    staleness bound D (`staleness`).
  * `TemporalState`    — the chains' state and consecutive-straggle ages
    (CPU tensors, like the realizations of `core.scenarios`).
  * `advance`          — one transition, then step k's realization:
    delayed stragglers (age ≤ D) participate, churned nodes and
    stragglers past the bound self-loop.
  * `ring_init` / `ring_push` — the snapshot ring, leaves [D, m, ...] on
    the run's device: slot k mod D holds the parameters at the start of
    step k, so a node delayed by τ ∈ [1, D] is read at slot (k − τ) mod D
    (`core.mixing.ring_gather`).

Randomness: the per-step draws use the scenario's streams (edge, node,
straggler: `fold_in(fold_in(seed, k), tag)`, tags 0, 1, 2), the stationary
initial draws and the mobility epochs their own folds, as in JAX.  Every
draw can be injected instead (``u=``): `advance` takes "edge" ([m, d], one
per undirected link), "node" and "strag" ([m]) and "mobility" ([m, d]);
`temporal_state_init` takes "edge", "node" and "strag".  Each chain reads
one uniform region per state, so the degenerate rates burst_up =
1 − burst_down and rejoin = 1 − leave reproduce the i.i.d. masks bit for
bit from the same uniforms, and staleness 0 excludes stragglers exactly
as the i.i.d. path does.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.pme import fold_in
from repro_torch.core.scenarios import (
    _EDGE,
    _NODE,
    _STRAG,
    Realization,
    ScenarioArrays,
    _uniform,
    realization_from_masks,
)
from repro_torch.tree import tree_map

__all__ = [
    "TemporalScenario",
    "TemporalState",
    "TemporalCarry",
    "TEMPORAL_PRESETS",
    "get_temporal_scenario",
    "list_temporal_scenarios",
    "temporal_state_init",
    "temporal_carry_init",
    "advance",
    "ring_init",
    "ring_push",
]

# seed folds of the stationary initial draws and the mobility epochs, the
# JAX package's constants (outside any reachable step index)
_INIT_EDGE_FOLD = 0x7FFFFFFF
_INIT_NODE_FOLD = 0x7FFFFFFE
_MOBILITY_FOLD = 0x7FFFFFFD
_INIT_STRAG_FOLD = 0x7FFFFFFC


@dataclasses.dataclass(frozen=True)
class TemporalScenario:
    """Markov network dynamics and bounded-staleness exchange."""

    name: str = "temporal"
    # Gilbert–Elliott per-edge burst process (undirected links)
    burst_down: float = 0.0   # P[good -> bad] per step
    burst_up: float = 0.5     # P[bad -> good] per step
    # geometric node sessions
    leave: float = 0.0        # P[up -> down] per step
    rejoin: float = 0.5       # P[down -> up] per step
    # mobility-style resampling of the active edge subset
    resample_every: int = 0   # epoch length in steps; 0 = off
    mobility_keep: float = 1.0  # P[base edge active within an epoch]
    # stragglers and bounded staleness
    straggler: float = 0.0    # i.i.d. P[node is late this step]
    straggle_on: float = 0.0  # Markov P[fresh -> late] per step
    straggle_off: float = 0.5  # Markov P[late -> fresh] per step
    staleness: int = 0        # D: max delay mixed from the ring; 0 = late
    #                           nodes are excluded, as on the i.i.d. path
    seed: int = 0

    def __post_init__(self):
        for field in ("burst_down", "burst_up", "leave", "rejoin",
                      "mobility_keep", "straggler", "straggle_on", "straggle_off"):
            v = getattr(self, field)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{field}={v} must be a probability in [0, 1]")
        if self.staleness < 0:
            raise ValueError(f"staleness={self.staleness} must be >= 0")
        if self.resample_every < 0:
            raise ValueError(f"resample_every={self.resample_every} must be >= 0")
        if self.burst_down > 0.0 and self.burst_up == 0.0:
            raise ValueError("burst_up=0 would make bad links permanent")
        if self.leave > 0.0 and self.rejoin == 0.0:
            raise ValueError("rejoin=0 would make departures permanent")
        if self.straggle_on > 0.0 and self.straggle_off == 0.0:
            raise ValueError("straggle_off=0 would make lateness permanent")
        if self.straggle_on > 0.0 and self.straggler > 0.0:
            raise ValueError(
                "straggler and straggle_on are mutually exclusive: pick the "
                "i.i.d. rate or the Markov session chain, not both"
            )

    @property
    def is_static(self) -> bool:
        """True iff every step realizes the base graph exactly."""
        return (
            self.burst_down == self.leave == self.straggler == 0.0
            and self.straggle_on == 0.0
            and (self.resample_every == 0 or self.mobility_keep == 1.0)
        )

    @property
    def mobile(self) -> bool:
        return self.resample_every > 0 and self.mobility_keep < 1.0

    @property
    def stationary_bad(self) -> float:
        """Stationary P[edge bad] of the Gilbert–Elliott chain."""
        denom = self.burst_down + self.burst_up
        return self.burst_down / denom if denom > 0.0 else 0.0

    @property
    def stationary_down(self) -> float:
        """Stationary P[node down] of the session chain."""
        denom = self.leave + self.rejoin
        return self.leave / denom if denom > 0.0 else 0.0

    @property
    def stationary_late(self) -> float:
        """Stationary P[node late] of the straggler session chain."""
        denom = self.straggle_on + self.straggle_off
        return self.straggle_on / denom if denom > 0.0 else 0.0

    @property
    def mean_burst_len(self) -> float:
        return 1.0 / self.burst_up if self.burst_down > 0.0 else 0.0

    @property
    def mean_session_len(self) -> float:
        return 1.0 / self.leave if self.leave > 0.0 else float("inf")


TEMPORAL_PRESETS = {
    "bursty_links": TemporalScenario(name="bursty_links", burst_down=0.05, burst_up=0.25),
    "sessions": TemporalScenario(name="sessions", leave=0.03, rejoin=0.2),
    "mobile": TemporalScenario(name="mobile", resample_every=25, mobility_keep=0.6),
    "stale_stragglers": TemporalScenario(name="stale_stragglers", straggler=0.4, staleness=3),
    "straggle_sessions": TemporalScenario(
        name="straggle_sessions", straggle_on=0.1, straggle_off=0.25, staleness=3),
    "markov_harsh": TemporalScenario(
        name="markov_harsh", burst_down=0.08, burst_up=0.3,
        leave=0.05, rejoin=0.3, straggler=0.3, staleness=2),
}


def get_temporal_scenario(name: str) -> TemporalScenario:
    if name not in TEMPORAL_PRESETS:
        raise ValueError(
            f"unknown temporal scenario {name!r}; pick from {sorted(TEMPORAL_PRESETS)}"
        )
    return TEMPORAL_PRESETS[name]


def list_temporal_scenarios() -> Tuple[str, ...]:
    return tuple(TEMPORAL_PRESETS)


class TemporalState(NamedTuple):
    """Markov state carried from step to step (CPU tensors)."""

    edge_bad: torch.Tensor   # [m, d] bool — Gilbert–Elliott bad state
    node_down: torch.Tensor  # [m] bool — session chain down state
    age: torch.Tensor        # [m] int32 — consecutive straggle count
    late: torch.Tensor       # [m] bool — straggler session state


class TemporalCarry(NamedTuple):
    """The auxiliary carry of a temporal run: the chains' state and the
    staleness ring (None when staleness is off)."""

    ts: TemporalState
    ring: Optional[object]


def temporal_state_init(scenario: TemporalScenario, arrays: ScenarioArrays, *,
                        u: Optional[dict] = None) -> TemporalState:
    """Stationary initial draw, so occupancies match the stationary law
    from step 0."""
    m, d = arrays.nbrs.shape
    edge_bad = torch.zeros((m, d), dtype=torch.bool)
    if scenario.burst_down > 0.0:
        edge_bad = _uniform(u, "edge", fold_in(arrays.key, _INIT_EDGE_FOLD), (m, d),
                            arrays.nbrs) < scenario.stationary_bad
    node_down = torch.zeros(m, dtype=torch.bool)
    if scenario.leave > 0.0:
        node_down = _uniform(u, "node", fold_in(arrays.key, _INIT_NODE_FOLD), (m,)
                             ) < scenario.stationary_down
    late = torch.zeros(m, dtype=torch.bool)
    if scenario.straggle_on > 0.0:
        late = _uniform(u, "strag", fold_in(arrays.key, _INIT_STRAG_FOLD), (m,)
                        ) < scenario.stationary_late
    return TemporalState(edge_bad, node_down, torch.zeros(m, dtype=torch.int32), late)


def temporal_carry_init(scenario: TemporalScenario, arrays: ScenarioArrays,
                        params_stacked, *, u: Optional[dict] = None) -> TemporalCarry:
    return TemporalCarry(ts=temporal_state_init(scenario, arrays, u=u),
                         ring=ring_init(params_stacked, scenario.staleness))


def advance(scenario: TemporalScenario, arrays: ScenarioArrays, ts: TemporalState,
            k: int, *, u: Optional[dict] = None
            ) -> Tuple[TemporalState, Realization, torch.Tensor, torch.Tensor]:
    """One transition and step k's realization: ``(new_state, realization,
    delayed, tau)``, where ``delayed`` [m] marks nodes participating
    through their ring snapshot and ``tau`` [m] is each node's delay (0
    when fresh)."""
    m, d = arrays.nbrs.shape
    kk = fold_in(arrays.key, int(k))

    edge_bad = ts.edge_bad
    if scenario.burst_down > 0.0:
        x = _uniform(u, "edge", fold_in(kk, _EDGE), (m, d), arrays.nbrs)
        edge_bad = torch.where(ts.edge_bad, x < 1.0 - scenario.burst_up,
                               x < scenario.burst_down)
    node_down = ts.node_down
    if scenario.leave > 0.0:
        x = _uniform(u, "node", fold_in(kk, _NODE), (m,))
        node_down = torch.where(ts.node_down, x < 1.0 - scenario.rejoin, x < scenario.leave)
    if scenario.straggle_on > 0.0:
        # the session chain reads the uniform region the i.i.d. draw reads
        x = _uniform(u, "strag", fold_in(kk, _STRAG), (m,))
        late = torch.where(ts.late, x < 1.0 - scenario.straggle_off, x < scenario.straggle_on)
        straggler = late
    elif scenario.straggler > 0.0:
        straggler = _uniform(u, "strag", fold_in(kk, _STRAG), (m,)) < scenario.straggler
        late = straggler
    else:
        straggler = late = torch.zeros(m, dtype=torch.bool)

    edge_up = ~edge_bad
    if scenario.mobile:
        epoch = int(k) // scenario.resample_every
        x = _uniform(u, "mobility", fold_in(fold_in(arrays.key, _MOBILITY_FOLD), epoch),
                     (m, d), arrays.nbrs)
        edge_up = edge_up & (x < scenario.mobility_keep)

    alive = ~node_down
    age = torch.where(straggler, ts.age + 1, torch.zeros_like(ts.age))
    if scenario.staleness > 0:
        delayed = straggler & alive & (age <= scenario.staleness)
    else:
        delayed = torch.zeros(m, dtype=torch.bool)
    excluded = straggler & ~delayed
    realization = realization_from_masks(arrays, edge_up, alive, excluded)
    tau = torch.where(delayed, age, torch.zeros_like(age))
    return TemporalState(edge_bad, node_down, age, late), realization, delayed, tau


def ring_init(params_stacked, staleness: int) -> Optional[object]:
    """[D, m, ...] snapshot ring seeded with the initial parameters (a node
    delayed at step k < τ reads the initial point).  None when staleness
    is off."""
    if staleness <= 0:
        return None
    return tree_map(
        lambda x: x.detach().unsqueeze(0).repeat((staleness,) + (1,) * x.dim()),
        params_stacked,
    )


def ring_push(ring, params_stacked, k: int, staleness: int):
    """Write the parameters at the start of step k into slot k mod D, in
    place (after the step's reads: slot (k − τ) mod D still held
    x^{k−τ} for every τ ≤ D while step k was realized)."""
    slot = int(k) % staleness
    with torch.no_grad():
        tree_map(lambda r, x: r[slot].copy_(x), ring, params_stacked)
    return ring
