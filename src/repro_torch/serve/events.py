"""Request arrival processes and arrival-driven round pacing (port of
`repro.serve.events`).

The serving half of serve-while-train: every node fields a stream of
inference requests while it trains.  Arrivals are sampled per node per
training round from a plain Poisson process or a Markov-modulated Poisson
process (MMPP: a hidden per-node burst chain switches the rate between
``rate`` and ``burst_rate``); each node serves up to ``capacity`` queued
requests a round, and a node whose backlog exceeds ``defer_threshold``
defers its gossip exchange for the round: it keeps taking local steps (the
paper's straggler semantics, a self-loop in the realized B^k) but stops
answering pulls until its queue drains.

The event clock lives on the host, in CPU tensors, beside the scenario
realizations it feeds: the busy mask ORs into the straggler mask before
the round's weights are built (`core.scenarios.realization_from_masks`),
so the host knows it without reading the card.

Randomness: JAX draws ``split(fold_in(key, k))`` uniforms and
``jax.random.poisson``, which torch cannot reproduce.  The port draws
counter-mode from CPU generators seeded with ``fold_in(fold_in(seed, k),
tag)`` (tag 0: the burst chain's uniforms, tag 1: the arrivals), and
:meth:`ServePacing.advance` takes the draws instead (``u={"mod": [m]
uniforms, "arrivals": [m] int32}``), which is how the parity tests feed it
JAX's.

Latency accounting is Little's law: ``wait`` accumulates the post-serve
backlog, so ``wait_i / served_i`` is node i's mean request sojourn in
rounds, the staleness of the served model.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "ArrivalProcess",
    "ARRIVAL_PRESETS",
    "get_arrival",
    "list_arrivals",
    "EventState",
    "PacedCarry",
    "ServePacing",
    "expand_events",
    "shrink_events",
]

_MOD, _ARR = 0, 1  # fold_in tags of the burst chain's and the arrivals' draws


@dataclasses.dataclass(frozen=True)
class ArrivalProcess:
    """Per-node request arrival model, sampled once per training round.

    ``burst_rate == 0`` is a plain Poisson(rate) process; ``burst_rate >
    0`` an MMPP: a hidden two-state chain per node (quiet -> burst with
    ``p_up``, burst -> quiet with ``p_down``), arrivals Poisson at the
    state's rate.  Rates are requests / node / round.
    """

    name: str = "off"
    rate: float = 0.0        # quiet-state mean arrivals per round
    burst_rate: float = 0.0  # burst-state rate (0 = plain Poisson)
    p_up: float = 0.05       # P[quiet -> burst] per round
    p_down: float = 0.25     # P[burst -> quiet] per round
    seed: int = 0

    def __post_init__(self):
        if self.rate < 0.0 or self.burst_rate < 0.0:
            raise ValueError("arrival rates must be non-negative")
        for field in ("p_up", "p_down"):
            v = getattr(self, field)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{field}={v} must be a probability in [0, 1]")

    @property
    def modulated(self) -> bool:
        return self.burst_rate > 0.0

    @property
    def is_static(self) -> bool:
        """True iff no requests ever arrive (pacing is a no-op)."""
        return self.rate == 0.0 and self.burst_rate == 0.0


ARRIVAL_PRESETS = {
    "off": ArrivalProcess(name="off"),
    "quiet": ArrivalProcess(name="quiet", rate=0.5),
    "steady": ArrivalProcess(name="steady", rate=2.0),
    "bursty": ArrivalProcess(name="bursty", rate=0.5, burst_rate=8.0, p_up=0.05, p_down=0.25),
    "rush": ArrivalProcess(name="rush", rate=4.0, burst_rate=16.0, p_up=0.1, p_down=0.1),
}


def get_arrival(name: str) -> ArrivalProcess:
    if name not in ARRIVAL_PRESETS:
        raise ValueError(f"unknown arrival preset {name!r}; pick from {sorted(ARRIVAL_PRESETS)}")
    return ARRIVAL_PRESETS[name]


def list_arrivals() -> Tuple[str, ...]:
    return tuple(ARRIVAL_PRESETS)


class EventState(NamedTuple):
    """The event clock (CPU tensors).  The cumulative counters survive the
    whole run, membership changes included (`expand_events`,
    `shrink_events`), so run-level QPS and latency read off the last one."""

    hi: torch.Tensor       # [m] bool — MMPP burst-chain state
    queue: torch.Tensor    # [m] int32 — backlog after this round's serving
    arrived: torch.Tensor  # [m] int32 — cumulative arrivals
    served: torch.Tensor   # [m] int32 — cumulative served requests
    wait: torch.Tensor     # [m] f32 — backlog integral (Little's law)
    key: int               # the seed, folded with the step index


class PacedCarry(NamedTuple):
    """Auxiliary carry of a paced bind: the event clock plus the inner
    carry (the FaultCarry of a fault-injected bind, else None, which the
    trees treat as an empty subtree)."""

    events: EventState
    inner: Optional[object]


@dataclasses.dataclass(frozen=True)
class ServePacing:
    """Arrival-driven gossip pacing for one bound algorithm.

    Per round and node: arrivals from the process, up to ``capacity``
    served, and a post-serve backlog above ``defer_threshold`` marks the
    node busy: it defers the round's exchange exactly like a scenario
    straggler (local update still applied, self-loop in B^k).
    """

    process: ArrivalProcess = ArrivalProcess()
    capacity: int = 4         # requests a node can serve per round
    defer_threshold: int = 8  # backlog beyond which gossip defers

    def __post_init__(self):
        if self.capacity < 0:
            raise ValueError("capacity must be >= 0")
        if self.defer_threshold < 0:
            raise ValueError("defer_threshold must be >= 0")

    @property
    def is_static(self) -> bool:
        """True iff the process never generates load: a static pacing binds
        the plain unpaced program, bit for bit."""
        return self.process.is_static

    def init(self, m: int, key: Optional[int] = None) -> EventState:
        """A fresh event clock for m nodes (queues empty, chains quiet)."""
        return EventState(
            hi=torch.zeros(m, dtype=torch.bool),
            queue=torch.zeros(m, dtype=torch.int32),
            arrived=torch.zeros(m, dtype=torch.int32),
            served=torch.zeros(m, dtype=torch.int32),
            wait=torch.zeros(m, dtype=torch.float32),
            key=int(self.process.seed if key is None else key),
        )

    def advance(self, es: EventState, k: int, *, u: Optional[dict] = None
                ) -> Tuple[EventState, torch.Tensor, dict]:
        """One round of the event clock: ``(new_state, busy, metrics)``,
        ``busy`` the [m] bool defer mask the step ORs into its straggler
        mask, ``metrics`` the round's queue depth, served requests and
        deferred node count.  ``u`` supplies the draws (``"mod"``: [m] f32
        uniforms of the burst chain, ``"arrivals"``: [m] int32)."""
        # `repro_torch.core` imports this module (the registry's pacing), so
        # its samplers' seeding helpers are imported at call time
        from repro_torch.core.pme import fold_in, make_generator

        proc = self.process
        m = es.queue.shape[0]
        kk = fold_in(es.key, int(k))
        u = u or {}
        hi = es.hi
        if proc.modulated:
            if "mod" in u:
                um = torch.as_tensor(u["mod"]).cpu().to(torch.float32)
            else:
                um = torch.rand(m, generator=make_generator(fold_in(kk, _MOD), "cpu"))
            hi = torch.where(es.hi, um >= proc.p_down, um < proc.p_up)
            lam = torch.where(hi, torch.tensor(proc.burst_rate, dtype=torch.float32),
                              torch.tensor(proc.rate, dtype=torch.float32))
        else:
            lam = torch.full((m,), proc.rate, dtype=torch.float32)
        if "arrivals" in u:
            arrivals = torch.as_tensor(u["arrivals"]).cpu().to(torch.int32)
        else:
            arrivals = torch.poisson(
                lam, generator=make_generator(fold_in(kk, _ARR), "cpu")).to(torch.int32)
        backlog = es.queue + arrivals
        served_now = torch.clamp(backlog, max=self.capacity)
        queue = backlog - served_now
        busy = queue > self.defer_threshold
        new_es = EventState(
            hi=hi,
            queue=queue,
            arrived=es.arrived + arrivals,
            served=es.served + served_now,
            wait=es.wait + queue.to(torch.float32),
            key=es.key,
        )
        metrics = {
            "queue_depth": queue.to(torch.float32).mean(),
            "served_reqs": served_now.sum().to(torch.float32),
            "deferred_nodes": busy.sum().to(torch.int32),
        }
        return new_es, busy, metrics


def expand_events(es: EventState, n_new: int) -> EventState:
    """Grow the event clock for n_new joining nodes: new nodes start quiet
    with empty queues and zero counters; the incumbents' cumulative
    accounting carries through the join."""
    if n_new <= 0:
        return es

    def grow(x):
        return torch.cat([x, torch.zeros(n_new, dtype=x.dtype)])

    return EventState(hi=grow(es.hi), queue=grow(es.queue), arrived=grow(es.arrived),
                      served=grow(es.served), wait=grow(es.wait), key=es.key)


def shrink_events(es: EventState, keep) -> EventState:
    """Shrink the event clock to the survivors of a graceful leave: ``keep``
    indexes them in the pre-departure numbering, and their accounting
    carries through.  A departed node's queued requests leave with it."""
    keep = torch.as_tensor(np.asarray(keep, np.int64))
    if keep.shape[0] == es.queue.shape[0]:
        return es
    return EventState(hi=es.hi[keep], queue=es.queue[keep], arrived=es.arrived[keep],
                      served=es.served[keep], wait=es.wait[keep], key=es.key)
