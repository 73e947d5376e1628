"""Elastic membership: nodes joining and leaving a running DFL system (port
of `repro.serve.membership`).

The fault layer's crash/rejoin chain (`core.faults`) keeps the node count
fixed.  This module changes it mid-run:

  * `grown_topology` attaches each new node to ``degree`` uniform existing
    nodes and re-derives the Metropolis–Hastings weights over the grown
    graph (symmetric, hence doubly stochastic and mean-preserving).
  * `expand_state` grows every node-stacked state leaf with donor rows:
    a new node catches up by cloning a trained neighbour, from the live
    state or from a restored checkpoint (`repro_torch.checkpoint`).
  * `shrunk_topology` + `retire_state` are the graceful departure: a
    leaving node hands its parameter mass to its neighbours (each survivor
    j absorbs β_j·(x_ℓ − x̄), β_j = B_ℓj / (1 − B_ℓℓ)), so the survivor
    mean equals the pre-departure mean; then the weights are re-derived.
  * `parse_chaos_spec` reads the chaos timeline (``"leave@200:2,
    partition@400:bridge,heal@800,join@900:1"``) and `chaos_partitions`
    folds its partition / heal pairs into `core.scenarios.PartitionWindow`s.
  * `check_membership_faults` refuses timelines that would silently give
    a non-stochastic realization, and crash faults with membership changes.

The topology half is numpy and the JAX package's code, so every graph,
weight matrix and donor list is bitwise equal to JAX's.  The state half
works on tensors where they lie: `expand_state` concatenates rows on the
leaf's device, and `retire_state` keeps JAX's arithmetic (mean in f32 cast
to the leaf's type, deviation in the leaf's type, β·deviation in f32 cast
to the leaf's type, the sum in the leaf's type) a block of columns at a
time, so no f32 copy of a whole full-width leaf is made.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import faults as flt_mod
from repro_torch.core.scenarios import PartitionWindow
from repro_torch.core.topology import Topology, metropolis_matrix, spectral_gap_zeta
from repro_torch.tree import tree_map

__all__ = [
    "JoinEvent",
    "ChaosEvent",
    "parse_join_spec",
    "parse_chaos_spec",
    "chaos_partitions",
    "topology_from_adjacency",
    "grown_topology",
    "shrunk_topology",
    "default_donors",
    "expand_state",
    "node_mean",
    "retire_state",
    "check_join_faults",
    "check_membership_faults",
]

# columns of a leaf `node_mean` and `retire_state` take at a time: a [5,
# 2^24] f32 block is 320 MB, a whole full-width leaf would be 5.5 GB
BLOCK_COLS = 1 << 24


@dataclasses.dataclass(frozen=True)
class JoinEvent:
    """``n_new`` nodes join at global step ``step``, each attaching to
    ``degree`` uniform existing nodes (drawn from ``seed`` and the current
    node count, so repeated events draw fresh attachments)."""

    step: int
    n_new: int
    degree: int = 2

    def __post_init__(self):
        if self.step < 0 or self.n_new < 0:
            raise ValueError("join step and n_new must be non-negative")
        if self.degree < 1:
            raise ValueError("join degree must be >= 1")


def parse_join_spec(spec: Optional[str], degree: int = 2) -> Tuple[JoinEvent, ...]:
    """Parse ``"STEP:N[:DEGREE]"`` comma lists (e.g. ``"40:2,80:2"``)."""
    if not spec:
        return ()
    events = []
    for part in spec.split(","):
        fields = part.strip().split(":")
        if len(fields) not in (2, 3):
            raise ValueError(f"join spec {part!r} is not STEP:N or STEP:N:DEGREE")
        events.append(JoinEvent(step=int(fields[0]), n_new=int(fields[1]),
                                degree=int(fields[2]) if len(fields) == 3 else degree))
    return tuple(sorted(events, key=lambda e: e.step))


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One entry of a chaos timeline: ``"leave"`` (the ``n`` highest-id
    nodes depart gracefully: LIFO, so state rows stay contiguous),
    ``"join"`` (``n`` new nodes, each attached to ``degree`` existing
    ones), ``"partition"`` (the graph splits into ``n`` connected
    components, a seeded multi-source BFS cut) or ``"heal"`` (the open
    partition re-merges)."""

    step: int
    kind: str
    n: int = 0
    degree: int = 2

    def __post_init__(self):
        if self.kind not in ("leave", "join", "partition", "heal"):
            raise ValueError(f"unknown chaos event kind {self.kind!r}")
        if self.step < 0:
            raise ValueError("chaos event step must be non-negative")
        if self.kind in ("leave", "join") and self.n < 0:
            raise ValueError(f"{self.kind} count must be non-negative")
        if self.kind == "partition" and self.n < 2:
            raise ValueError("a partition needs at least 2 components")
        if self.kind == "join" and self.degree < 1:
            raise ValueError("join degree must be >= 1")


def parse_chaos_spec(spec: Optional[str], degree: int = 2) -> Tuple[ChaosEvent, ...]:
    """Parse comma-separated ``KIND@STEP[:ARG[:ARG]]`` entries:
    ``leave@STEP:N``, ``partition@STEP:bridge`` (2 components),
    ``partition@STEP:P``, ``heal@STEP`` and ``join@STEP:N[:DEG]``.  Events
    come back sorted by step; an empty or None spec is the empty timeline."""
    if not spec:
        return ()
    events = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "@" not in part:
            raise ValueError(f"chaos event {part!r} is not KIND@STEP[:ARG[:ARG]]")
        kind, _, rest = part.partition("@")
        fields = rest.split(":")
        kind = kind.strip()
        if kind == "heal":
            if len(fields) != 1:
                raise ValueError(f"heal takes no argument: {part!r}")
            events.append(ChaosEvent(step=int(fields[0]), kind="heal"))
        elif kind == "partition":
            if len(fields) != 2:
                raise ValueError(
                    f"partition needs one argument (bridge or a part count): {part!r}")
            n = 2 if fields[1].strip() == "bridge" else int(fields[1])
            events.append(ChaosEvent(step=int(fields[0]), kind="partition", n=n))
        elif kind == "leave":
            if len(fields) != 2:
                raise ValueError(f"leave needs a node count: {part!r}")
            events.append(ChaosEvent(step=int(fields[0]), kind="leave", n=int(fields[1])))
        elif kind == "join":
            if len(fields) not in (2, 3):
                raise ValueError(f"join is join@STEP:N[:DEGREE]: {part!r}")
            events.append(ChaosEvent(step=int(fields[0]), kind="join", n=int(fields[1]),
                                     degree=int(fields[2]) if len(fields) == 3 else degree))
        else:
            raise ValueError(
                f"unknown chaos event kind {kind!r} in {part!r} (leave/partition/heal/join)")
    return tuple(sorted(events, key=lambda e: e.step))


def chaos_partitions(events: Sequence[ChaosEvent], num_steps: int,
                     seed: int = 0) -> Tuple[PartitionWindow, ...]:
    """Fold a timeline's partition / heal pairs into `PartitionWindow`s: each
    ``partition`` opens a window that the next ``heal`` closes, and an
    unhealed one runs to ``num_steps``.  A heal without an open partition,
    or a partition while one is open, raises."""
    windows = []
    open_ev: Optional[ChaosEvent] = None
    for ev in sorted(events, key=lambda e: e.step):
        if ev.kind == "partition":
            if open_ev is not None:
                raise ValueError(
                    f"partition@{ev.step} while the partition@{open_ev.step} "
                    "window is still open (heal it first)")
            open_ev = ev
        elif ev.kind == "heal":
            if open_ev is None:
                raise ValueError(f"heal@{ev.step} without an open partition")
            windows.append(PartitionWindow(start=open_ev.step, heal=ev.step,
                                           n_parts=open_ev.n, seed=seed))
            open_ev = None
    if open_ev is not None:
        windows.append(PartitionWindow(start=open_ev.step,
                                       heal=max(num_steps, open_ev.step + 1),
                                       n_parts=open_ev.n, seed=seed))
    return tuple(windows)


def topology_from_adjacency(a: np.ndarray) -> Topology:
    """A Topology (neighbour sets, Metropolis–Hastings mixing, spectral
    gap) from an explicit symmetric 0/1 adjacency."""
    a = np.asarray(a)
    m = a.shape[0]
    if a.shape != (m, m) or not np.array_equal(a, a.T):
        raise ValueError("adjacency must be square and symmetric")
    if np.any(np.diag(a) != 0):
        raise ValueError("adjacency must have a zero diagonal")
    nsets = tuple(tuple(int(j) for j in np.nonzero(a[i])[0]) for i in range(m))
    b = metropolis_matrix(a)
    return Topology(m=m, adjacency=a, neighbor_sets=nsets, mixing=b,
                    zeta=spectral_gap_zeta(b))


def grown_topology(topo: Topology, n_new: int, degree: int = 2, seed: int = 0) -> Topology:
    """Grow the graph by n_new nodes, each attached to ``degree`` uniform
    existing nodes (every new node has a trained donor, and the grown
    graph is connected when the base graph is).  The attachments are drawn
    from ``default_rng((seed, topo.m))``."""
    if n_new == 0:
        return topo
    m_old, m_new = topo.m, topo.m + n_new
    rng = np.random.default_rng((int(seed), int(topo.m)))
    a = np.zeros((m_new, m_new), dtype=topo.adjacency.dtype)
    a[:m_old, :m_old] = topo.adjacency
    for idx in range(n_new):
        i = m_old + idx
        targets = rng.choice(m_old, size=min(degree, m_old), replace=False)
        a[i, targets] = 1
        a[targets, i] = 1
    return topology_from_adjacency(a)


def shrunk_topology(topo: Topology, leavers: Sequence[int]) -> Topology:
    """Remove ``leavers`` and re-derive the weights over the survivors,
    whose ids compact downward in order.  Zero leavers return ``topo``
    itself."""
    leavers = sorted({int(i) for i in leavers})
    if not leavers:
        return topo
    if leavers[0] < 0 or leavers[-1] >= topo.m:
        raise ValueError(f"leavers must index nodes [0, {topo.m})")
    if len(leavers) >= topo.m:
        raise ValueError(f"cannot retire all {topo.m} nodes — at least one must remain")
    keep = np.asarray([i for i in range(topo.m) if i not in set(leavers)])
    return topology_from_adjacency(topo.adjacency[np.ix_(keep, keep)])


def default_donors(topo_new: Topology, m_old: int) -> np.ndarray:
    """Each new node's donor: its lowest-id neighbour among the old nodes."""
    donors = []
    for i in range(m_old, topo_new.m):
        olds = [j for j in topo_new.neighbor_sets[i] if j < m_old]
        if not olds:
            raise ValueError(f"new node {i} has no old-node neighbor")
        donors.append(min(olds))
    return np.asarray(donors, np.int64)


def _stacked(leaf, m: int) -> bool:
    """A node-stacked leaf: a tensor whose leading axis is exactly m."""
    return isinstance(leaf, torch.Tensor) and leaf.dim() >= 1 and leaf.shape[0] == m


def expand_state(state, m_old: int, donors: Sequence[int], source_state=None):
    """Grow every node-stacked leaf of ``state`` (leading axis exactly
    ``m_old``) by len(donors) rows: the donors' rows of ``source_state``
    (default the live state; a restored checkpoint for checkpoint
    catch-up), moved to the leaf's device.  Scalars and unstacked leaves
    pass through.  Empty ``donors`` return ``state`` itself."""
    donors = np.asarray(donors, np.int64)
    if donors.size == 0:
        return state
    if np.any(donors < 0) or np.any(donors >= m_old):
        raise ValueError(f"donors must index old nodes [0, {m_old})")
    src = state if source_state is None else source_state
    didx = torch.as_tensor(donors)

    def grow(leaf, s_leaf):
        if not _stacked(leaf, m_old):
            return leaf
        rows = s_leaf[didx.to(s_leaf.device)].to(leaf.device)
        return torch.cat([leaf, rows], dim=0)

    return tree_map(grow, state, src)


def node_mean(leaf: torch.Tensor) -> torch.Tensor:
    """A node-stacked leaf's mean over its m rows, flattened, in f32 on the
    leaf's device: XLA's `jnp.mean` (the f32 sum in node order times
    f32(1/m)), BLOCK_COLS columns at a time."""
    x = leaf.reshape(leaf.shape[0], -1)
    out = torch.empty(x.shape[1], dtype=torch.float32, device=leaf.device)
    inv_m = float(np.float32(1.0) / np.float32(x.shape[0]))
    for c0 in range(0, x.shape[1], BLOCK_COLS):
        blk = x[:, c0:c0 + BLOCK_COLS]
        acc = blk[0].to(torch.float32)
        for i in range(1, x.shape[0]):
            acc = acc + blk[i].to(torch.float32)
        out[c0:c0 + BLOCK_COLS] = acc * inv_m
    return out


def _retire_leaf(leaf: torch.Tensor, ell: int, keep: torch.Tensor,
                 beta: torch.Tensor) -> torch.Tensor:
    """One leaf without row ℓ, each survivor j plus β_j·(x_ℓ − x̄): the mean
    (`node_mean`) cast to the leaf's type, the deviation in the leaf's
    type, β·deviation in f32 cast to the leaf's type, and the sum in the
    leaf's type (JAX's chain), BLOCK_COLS columns at a time."""
    m = leaf.shape[0]
    flat = leaf.reshape(m, -1)
    mean = node_mean(leaf).to(leaf.dtype)
    out = torch.empty((m - 1,) + tuple(leaf.shape[1:]), dtype=leaf.dtype, device=leaf.device)
    out_flat = out.reshape(m - 1, -1)
    b = beta.to(leaf.device)[:, None]
    keep = keep.to(leaf.device)
    for c0 in range(0, flat.shape[1], BLOCK_COLS):
        blk = flat[:, c0:c0 + BLOCK_COLS]
        dev = blk[ell] - mean[c0:c0 + BLOCK_COLS]
        out_flat[:, c0:c0 + BLOCK_COLS] = blk[keep] + (b * dev).to(leaf.dtype)
    return out


def retire_state(state, topo: Topology, leavers: Sequence[int]):
    """Shrink every node-stacked leaf, handing each leaver's parameter mass
    to its neighbours, mean-preserving by construction.

    For each leaver ℓ (highest id first, each against the current
    shrinking topology), every survivor j absorbs ``β_j · (x_ℓ − x̄)``
    with ``β_j = B_ℓj / (1 − B_ℓℓ)`` (Σβ_j = 1; an isolated leaver hands
    off uniformly) and x̄ the mean over all current nodes, so the survivor
    mean is x̄: (Σ_{j≠ℓ} x_j + x_ℓ − x̄) / (m − 1) = x̄.  Floating leaves
    hand off (leaves equal across nodes hand off a zero deviation);
    integer and bool leaves drop the leaver's row.  Zero leavers return
    ``state`` itself."""
    leavers = sorted({int(i) for i in leavers}, reverse=True)
    if not leavers:
        return state
    if leavers[-1] < 0 or leavers[0] >= topo.m:
        raise ValueError(f"leavers must index nodes [0, {topo.m})")
    if len(leavers) >= topo.m:
        raise ValueError(f"cannot retire all {topo.m} nodes — at least one must remain")
    cur_topo = topo
    for ell in leavers:
        m = cur_topo.m
        b_row = np.asarray(cur_topo.mixing[ell], np.float64)
        b_ll = float(b_row[ell])
        if b_ll >= 1.0 - 1e-12:  # isolated leaver: uniform handoff
            beta = np.full(m, 1.0 / (m - 1))
        else:
            beta = b_row / (1.0 - b_ll)
        beta[ell] = 0.0
        keep_np = np.asarray([i for i in range(m) if i != ell])
        keep = torch.as_tensor(keep_np)
        beta_keep = torch.as_tensor(beta[keep_np], dtype=torch.float32)

        def shrink(leaf, _ell=ell, _m=m, _keep=keep, _beta=beta_keep):
            if not _stacked(leaf, _m):
                return leaf
            if not (leaf.is_floating_point() or leaf.is_complex()):
                return leaf[_keep.to(leaf.device)]
            return _retire_leaf(leaf, _ell, _keep, _beta)

        with torch.no_grad():
            state = tree_map(shrink, state)
        cur_topo = shrunk_topology(cur_topo, (ell,))
    return state


def check_join_faults(faults: Optional[flt_mod.FaultModel]) -> None:
    """Refuse to mix the two recovery paths: crash faults use the fixed-m
    rejoin path (state frozen and restored in place), while joins grow m
    and re-derive the weights.  Loss, burst and delay chains re-initialize
    over the grown node set and stay allowed."""
    if faults is not None and faults.crash > 0.0:
        raise ValueError(
            "elastic membership (node joins) cannot be combined with crash "
            f"faults: FaultModel(crash={faults.crash}, rejoin={faults.rejoin}) "
            "uses the fixed-m rejoin path (state frozen and restored in place), "
            "while joins grow m and re-derive the mixing weights.  Run crashes "
            "via --crash without --join, or model churn with "
            "Scenario(churn=...) which composes with joins."
        )


def check_membership_faults(faults: Optional[flt_mod.FaultModel],
                            events: Sequence[ChaosEvent] = (),
                            m0: Optional[int] = None) -> None:
    """Validate a chaos timeline loudly.  Rejects crash faults with any
    membership change; a leave and a join at one step (their rows would
    alias); a membership change inside an open partition window (the
    component map was drawn over the old node set); a partition into more
    components than nodes remain; and, with ``m0``, a timeline that
    empties the graph."""
    events = tuple(sorted(events, key=lambda e: e.step))
    membership = [e for e in events if e.kind in ("leave", "join") and e.n > 0]
    if membership and faults is not None and faults.crash > 0.0:
        kinds = sorted({e.kind for e in membership})
        raise ValueError(
            f"chaos timeline schedules membership changes ({'/'.join(kinds)}) "
            f"but crash faults are bound (FaultModel(crash={faults.crash})): "
            "the fixed-m rejoin path freezes state rows in place, so a "
            "departure could retire a crashed node's stale snapshot and a "
            "join would rejoin crashes into a re-weighted graph.  Run "
            "crashes without membership changes, or drop --crash."
        )
    by_step: dict = {}
    for e in membership:
        by_step.setdefault(e.step, set()).add(e.kind)
    for step, kinds in sorted(by_step.items()):
        if len(kinds) > 1:
            raise ValueError(
                f"leave and join scheduled at the same step {step}: the "
                "retired and joining rows would alias — schedule them at "
                "distinct steps")
    open_since: Optional[int] = None
    m = m0
    for e in events:
        if e.kind == "partition":
            if m is not None and e.n > m:
                raise ValueError(
                    f"partition@{e.step} into {e.n} components, but only "
                    f"{m} nodes remain at that step")
            open_since = e.step
        elif e.kind == "heal":
            open_since = None
        elif open_since is not None:
            raise ValueError(
                f"{e.kind}@{e.step} inside the partition window open since "
                f"step {open_since}: the component map was drawn over the "
                "pre-change node set (it would partition already-departed "
                "or not-yet-joined nodes).  Heal the split before changing "
                "membership.")
        if m is not None:
            if e.kind == "leave":
                if e.n >= m:
                    raise ValueError(
                        f"leave@{e.step}:{e.n} would retire "
                        f"{'all' if e.n == m else 'more than all'} {m} remaining nodes")
                m -= e.n
            elif e.kind == "join":
                m += e.n
