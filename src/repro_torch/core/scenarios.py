"""Dynamic-network scenarios: time-varying graphs, churn, stragglers and
scheduled partitions (port of `repro.core.scenarios`).

Assumption 1 of the paper asks only that each round's matrix B^k be
doubly stochastic, not that the graph be fixed.  This module turns a
static `Topology` into per-step realizations:

  * `Scenario`       — the spec: per-step link-failure, churn and
                       straggler probabilities, plus scheduled
                       `PartitionWindow`s (persistent cross-component cuts
                       that heal).
  * `ScenarioArrays` — the base graph's padded neighbour table
                       (neighbours-then-self slot layout) and the seed.
  * `realize`        — step k's masks, then Metropolis–Hastings weights
                       rebuilt from the realized degrees: symmetric and
                       doubly stochastic over the surviving subgraph, every
                       non-participant self-loops with weight exactly 1.
  * `scenario_mixer` — one step's realization as a `Mixer` ("sparse",
                       "dense" or "matrix") on the run's device.
  * `freeze_dropped` — a node offline for the step keeps every floating
                       per-node leaf of its state bitwise.

Where the work happens differs from JAX, with the same results: the
realizations are small ([m, d] masks and weights), so the port samples and
builds them on the host, in CPU tensors, and moves only the weights and
masks a step consumes to the run's device.  Every decision that selects
rows (which nodes are dropped, which are delayed) is then known on the
host without reading the card, so a dropped node's rows are copied aside
before the step and put back after it (`dropped_rows` / `restore_rows`)
instead of cloning the whole state.

Randomness: JAX folds the step index into the scenario key and splits it
three ways (edge, node, straggler).  The port draws from CPU generators
seeded with `fold_in(fold_in(seed, k), tag)`, tags 0, 1 and 2 in the same
roles, and `sample_masks` / `realize` take the uniforms instead
(``u={"edge": [m, d], "node": [m], "strag": [m]}``), which is how the
parity tests feed them JAX's.  A zero-rate draw is skipped, as in JAX, so
it never perturbs another stream.  Masks compare f32 uniforms with the
probabilities as JAX does (``uniform < p`` for Bernoulli draws).

Sparse and dense scenario mixers agree to fp tolerance only (the
neighbours-then-self layout is not the ascending order of
`Topology.mixing_padded`), as in JAX.

Lanes (`core.lanes`): `fold_arrays` stacks L copies of the base graph
over L·m rows, every slot of lane l (padding and self slots included)
offset by l·m, so that no lane's row reads another lane's, not even at
weight 0 (0·NaN is NaN).  Each lane draws its own masks (`sample_masks`
with its own key) and `realization_from_masks` builds the folded
`Realization` from the concatenated masks in one pass (the arithmetic is
row by row, so each lane's rows are bit for bit its unbatched ones), or
`fold_realizations` stacks realizations built lane by lane.  A folded
realization's ``directed_edges`` is [L]; `scenario_mixer`,
`realization_matrix`, `dropped_rows` / `restore_rows` /
`freeze_dropped`, `active_components` and `component_stats` (``lanes=``)
take it.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import sharding as shd
from repro_torch.core import lanes as LN
from repro_torch.core.mixing import Mixer, PaddedMixing, _dense_padded, fold_padded
from repro_torch.core.pme import fold_in, make_generator
from repro_torch.core.topology import Topology
from repro_torch.tree import tree_flatten, tree_unflatten

__all__ = [
    "Scenario",
    "PartitionWindow",
    "ScenarioArrays",
    "Realization",
    "SCENARIO_PRESETS",
    "get_scenario",
    "list_scenarios",
    "make_scenario_arrays",
    "fold_arrays",
    "fold_realizations",
    "partition_components",
    "active_components",
    "component_stats",
    "edge_uniform",
    "sample_masks",
    "realize",
    "realization_from_masks",
    "realization_matrix",
    "scenario_mixer",
    "freeze_dropped",
    "dropped_rows",
    "restore_rows",
    "expected_matrix",
]

# fold_in tags of the three per-step draws (JAX: split(fold_in(key, k), 3))
_EDGE, _NODE, _STRAG = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class PartitionWindow:
    """One network split: every cross-component edge is cut for steps
    ``start <= k < heal``, then the heal step restores the base graph.
    The component map is explicit (``components``, covering every node
    once) or the BFS Voronoi cells of ``n_parts`` seeded nodes."""

    start: int
    heal: int
    n_parts: int = 2
    components: Optional[Tuple[Tuple[int, ...], ...]] = None
    seed: int = 0

    def __post_init__(self):
        if self.start < 0:
            raise ValueError("partition start must be non-negative")
        if self.heal <= self.start:
            raise ValueError(
                f"partition heal step {self.heal} must be after start {self.start}"
            )
        if self.components is not None:
            parts = tuple(tuple(int(i) for i in c) for c in self.components)
            object.__setattr__(self, "components", parts)
            object.__setattr__(self, "n_parts", len(parts))
        if self.n_parts < 2:
            raise ValueError("a partition needs n_parts >= 2")


@dataclasses.dataclass(frozen=True)
class Scenario:
    """Per-step network dynamics, sampled i.i.d. across steps."""

    name: str = "custom"
    edge_drop: float = 0.0   # P[a base edge fails this step]
    churn: float = 0.0       # P[a node is fully offline this step]
    straggler: float = 0.0   # P[a node misses the exchange this step]
    seed: int = 0
    # scheduled network splits, non-overlapping, sorted by start
    partitions: Tuple[PartitionWindow, ...] = ()

    def __post_init__(self):
        for field in ("edge_drop", "churn", "straggler"):
            v = getattr(self, field)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{field}={v} must be a probability in [0, 1]")
        wins = tuple(sorted(self.partitions, key=lambda w: w.start))
        object.__setattr__(self, "partitions", wins)
        for a, b in zip(wins, wins[1:]):
            if b.start < a.heal:
                raise ValueError(
                    f"partition windows overlap: [{a.start}, {a.heal}) and "
                    f"[{b.start}, {b.heal})"
                )

    @property
    def is_static(self) -> bool:
        """True iff every step realizes the base graph exactly."""
        return (self.edge_drop == self.churn == self.straggler == 0.0
                and not self.partitions)

    @property
    def max_parts(self) -> int:
        """Most components any scheduled window splits the graph into."""
        return max((w.n_parts for w in self.partitions), default=1)


SCENARIO_PRESETS = {
    "static": Scenario(name="static"),
    "flaky_links": Scenario(name="flaky_links", edge_drop=0.2),
    "churn": Scenario(name="churn", churn=0.1),
    "stragglers": Scenario(name="stragglers", straggler=0.3),
    # dynamic Erdős–Rényi: pair with a dense base graph (e.g. complete)
    "dynamic_er": Scenario(name="dynamic_er", edge_drop=0.5),
    "harsh": Scenario(name="harsh", edge_drop=0.2, churn=0.1, straggler=0.2),
}


def get_scenario(name: str) -> Scenario:
    if name not in SCENARIO_PRESETS:
        raise ValueError(
            f"unknown scenario {name!r}; pick from {sorted(SCENARIO_PRESETS)}"
        )
    return SCENARIO_PRESETS[name]


def list_scenarios() -> Tuple[str, ...]:
    return tuple(SCENARIO_PRESETS)


class ScenarioArrays(NamedTuple):
    """The base graph in padded form: the first d = max_degree slots are
    `Topology.neighbor_matrix_padded` (ascending ids, padding repeats the
    row's own id with `valid` False), slot d is the receiver itself.  The
    layout is PaME's `TopologyArrays`', so a realization's `edge_alive`
    applies to both.  CPU tensors (see the module docstring); `to(device)`
    gives the copy a step's mixer gathers with."""

    nbrs: torch.Tensor       # [m, d] int64
    valid: torch.Tensor      # [m, d] bool
    nbrs_full: torch.Tensor  # [m, d+1] int64 — neighbours then self
    is_self: torch.Tensor    # [m, d+1] bool — True only on the last slot
    key: int                 # the scenario seed
    part_cut: Optional[torch.Tensor] = None     # [P, m, d] bool — cut edges
    part_bounds: Optional[Tuple[Tuple[int, int], ...]] = None  # (start, heal)
    part_comp: Optional[torch.Tensor] = None    # [P, m] int32 component ids
    lanes: Optional[int] = None  # L for L lanes folded over L·m rows (`fold_arrays`)

    @property
    def m(self) -> int:
        """Rows of the table: the nodes, or L·m for folded arrays."""
        return self.nbrs.shape[0]

    def to(self, device) -> "ScenarioArrays":
        mv = lambda t: None if t is None else t.to(device)  # noqa: E731
        return self._replace(nbrs=mv(self.nbrs), valid=mv(self.valid),
                             nbrs_full=mv(self.nbrs_full), is_self=mv(self.is_self),
                             part_cut=mv(self.part_cut), part_comp=mv(self.part_comp))


def fold_arrays(arrays: ScenarioArrays, lanes: int) -> ScenarioArrays:
    """L copies of the base `arrays` over L·m rows: every slot of lane l,
    padding and the self slot included, offset by l·m (`core.lanes`); the
    masks and partition maps repeated lane by lane."""
    rep = lambda t: None if t is None else t.repeat(lanes, 1)  # noqa: E731
    part = lambda t: None if t is None else t.repeat(  # noqa: E731
        (1, lanes) + (1,) * (t.dim() - 2))
    return arrays._replace(
        nbrs=LN.offset_rows([arrays.nbrs] * lanes), valid=rep(arrays.valid),
        nbrs_full=LN.offset_rows([arrays.nbrs_full] * lanes), is_self=rep(arrays.is_self),
        part_cut=part(arrays.part_cut), part_comp=part(arrays.part_comp), lanes=lanes)


class Realization(NamedTuple):
    """One step's network state (CPU tensors).  Folded over L lanes
    (`fold_arrays`), the rows are L·m and ``directed_edges`` is [L]."""

    edge_alive: torch.Tensor      # [m, d] bool — realized bidirectional edges
    alive: torch.Tensor           # [m] bool — node not dropped by churn
    participating: torch.Tensor   # [m] bool — alive and not a straggler
    weights: torch.Tensor         # [m, d+1] f32 — per-slot receive weights
    directed_edges: torch.Tensor  # int32 scalar — realized directed edges


def fold_realizations(rs) -> Realization:
    """L lanes' realizations as one over their L·m rows (lane l's rows
    l·m ... l·m + m − 1), ``directed_edges`` [L]."""
    return Realization(*(torch.cat(xs) for xs in list(zip(*rs))[:4]),
                       directed_edges=torch.stack([r.directed_edges for r in rs]))


def partition_components(topo: Topology, window: PartitionWindow) -> np.ndarray:
    """One window's per-node component ids ([m] int32): the explicit
    components, or the multi-source BFS cells of ``n_parts`` seed nodes
    drawn from ``default_rng((seed, m, start))`` (nodes no seed reaches
    join component 0).  The JAX package's numpy code, so the maps are
    equal bit for bit."""
    m = topo.m
    comp = np.full(m, -1, np.int32)
    if window.components is not None:
        for c, members in enumerate(window.components):
            for i in members:
                if not 0 <= i < m:
                    raise ValueError(
                        f"partition component {c} names node {i}, but the "
                        f"graph has m={m} nodes (already departed?)"
                    )
                if comp[i] >= 0:
                    raise ValueError(f"node {i} appears in two partition components")
                comp[i] = c
        if np.any(comp < 0):
            missing = np.nonzero(comp < 0)[0].tolist()
            raise ValueError(
                f"partition components must cover every node; missing {missing}"
            )
        return comp
    if window.n_parts > m:
        raise ValueError(f"cannot split m={m} nodes into {window.n_parts} components")
    rng = np.random.default_rng((int(window.seed), int(m), int(window.start)))
    seeds = rng.choice(m, size=window.n_parts, replace=False)
    comp[seeds] = np.arange(window.n_parts, dtype=np.int32)
    frontier = list(int(s) for s in seeds)
    while frontier:
        nxt = []
        for i in frontier:
            for j in topo.neighbor_sets[i]:
                if comp[j] < 0:
                    comp[j] = comp[i]
                    nxt.append(j)
        frontier = nxt
    comp[comp < 0] = 0
    return comp


def make_scenario_arrays(topo: Topology, scenario) -> ScenarioArrays:
    nbrs, valid = topo.neighbor_matrix_padded()
    m, d = nbrs.shape
    is_self = np.zeros((m, d + 1), dtype=bool)
    is_self[:, d] = True
    part_cut = part_bounds = part_comp = None
    windows = getattr(scenario, "partitions", ())  # TemporalScenario has none
    if windows:
        comps = np.stack([partition_components(topo, w) for w in windows])  # [P, m]
        # an edge is cut while its window is open iff its endpoints lie in
        # different components (padding compares a node with itself)
        part_cut = torch.as_tensor(comps[:, :, None] != comps[:, nbrs])
        part_bounds = tuple((int(w.start), int(w.heal)) for w in windows)
        part_comp = torch.as_tensor(comps, dtype=torch.int32)
    return ScenarioArrays(
        nbrs=torch.as_tensor(nbrs, dtype=torch.int64),
        valid=torch.as_tensor(valid),
        nbrs_full=torch.as_tensor(
            np.concatenate([nbrs, np.arange(m)[:, None]], axis=1), dtype=torch.int64),
        is_self=torch.as_tensor(is_self),
        key=int(scenario.seed),
        part_cut=part_cut,
        part_bounds=part_bounds,
        part_comp=part_comp,
    )


def _row_sum(w: torch.Tensor) -> torch.Tensor:
    """Sum over the slot axis in ascending slot order (a fixed order, so
    the self weight is reproducible)."""
    acc = w[:, 0].clone()
    for s in range(1, w.shape[1]):
        acc = acc + w[:, s]
    return acc


def realization_from_masks(arrays: ScenarioArrays, edge_up: torch.Tensor,
                           alive: torch.Tensor, straggler: torch.Tensor) -> Realization:
    """The step's doubly stochastic weights from explicit masks:
    w_ij = 1/(1 + max(d_i, d_j)) on realized edges over the realized
    degrees, the self slot takes the rest.  Symmetric mask and formula,
    so the matrix is symmetric and doubly stochastic; non-participants
    self-loop with weight exactly 1.  Over folded arrays the masks are
    the lanes' concatenated ([L·m, d], [L·m]) and so is the result."""
    nbrs = arrays.nbrs.cpu()
    edge_up, alive, straggler = (t.cpu().bool() for t in (edge_up, alive, straggler))
    participating = alive & ~straggler
    edge_alive = arrays.valid.cpu() & edge_up & participating[:, None] & participating[nbrs]
    deg = edge_alive.sum(dim=1).to(torch.float32)
    w_off = torch.where(
        edge_alive, 1.0 / (1.0 + torch.maximum(deg[:, None], deg[nbrs])),
        torch.zeros((), dtype=torch.float32),
    ).to(torch.float32)
    self_w = 1.0 - _row_sum(w_off)
    lanes = arrays.lanes
    return Realization(
        edge_alive=edge_alive,
        alive=alive,
        participating=participating,
        weights=torch.cat([w_off, self_w[:, None]], dim=1),
        directed_edges=(edge_alive.sum() if lanes is None
                        else edge_alive.reshape(lanes, -1).sum(dim=1)).to(torch.int32),
    )


def edge_uniform(key: int, nbrs: torch.Tensor) -> torch.Tensor:
    """One uniform per *undirected* base link, shaped like the padded
    table [m, d]: both directions of a link read the same draw, so a mask
    made from it stays symmetric.  The links' canonical (lo, hi) ids are
    drawn for in ascending order; padding slots get their self pair's
    draw, which every caller masks out with `valid`."""
    nbrs = nbrs.cpu().long()
    m = nbrs.shape[0]
    row = torch.arange(m)[:, None]
    ids = torch.minimum(row, nbrs) * m + torch.maximum(row, nbrs)
    uniq, inverse = torch.unique(ids, sorted=True, return_inverse=True)
    draws = torch.rand(uniq.numel(), generator=make_generator(key, "cpu"))
    return draws[inverse]


def _uniform(u: Optional[dict], name: str, key: int, shape, nbrs=None) -> torch.Tensor:
    """The injected uniforms ``u[name]``, or a draw seeded with `key` (one
    per undirected link when the padded table `nbrs` is given)."""
    if u and name in u:
        return torch.as_tensor(u[name]).cpu().to(torch.float32)
    if nbrs is not None:
        return edge_uniform(key, nbrs)
    return torch.rand(shape, generator=make_generator(key, "cpu"))


def _window_cut(arrays: ScenarioArrays, k: int) -> Optional[torch.Tensor]:
    """[m, d] cut mask of the window open at step k, or None."""
    if arrays.part_bounds is None:
        return None
    for p, (start, heal) in enumerate(arrays.part_bounds):
        if start <= k < heal:
            return arrays.part_cut[p].cpu()
    return None


def sample_masks(scenario: Scenario, arrays: ScenarioArrays, k: int, *,
                 u: Optional[dict] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Step k's raw (edge_up, alive, straggler) masks.  ``u`` supplies the
    uniforms ("edge" [m, d] per undirected link, "node" [m], "strag" [m])
    instead of the seeded draws; a zero-rate draw is skipped."""
    m, d = arrays.nbrs.shape
    kk = fold_in(arrays.key, int(k))
    alive = torch.ones(m, dtype=torch.bool)
    if scenario.churn > 0.0:
        alive = ~(_uniform(u, "node", fold_in(kk, _NODE), (m,)) < scenario.churn)
    straggler = torch.zeros(m, dtype=torch.bool)
    if scenario.straggler > 0.0:
        straggler = _uniform(u, "strag", fold_in(kk, _STRAG), (m,)) < scenario.straggler
    edge_up = torch.ones((m, d), dtype=torch.bool)
    if scenario.edge_drop > 0.0:
        edge_up = _uniform(u, "edge", fold_in(kk, _EDGE), (m, d),
                           arrays.nbrs) >= scenario.edge_drop
    if getattr(scenario, "partitions", ()):
        cut = _window_cut(arrays, int(k))
        if cut is not None:
            edge_up = edge_up & ~cut
    return edge_up, alive, straggler


def realize(scenario: Scenario, arrays: ScenarioArrays, k: int, *,
            u: Optional[dict] = None) -> Realization:
    """Step k's network realization (`sample_masks` then
    `realization_from_masks`)."""
    return realization_from_masks(arrays, *sample_masks(scenario, arrays, k, u=u))


def active_components(arrays: ScenarioArrays, k: int) -> torch.Tensor:
    """Per-node component id at step k ([m] int32, [L·m] over folded
    arrays): zeros outside every window, the open window's map inside
    one."""
    if arrays.part_bounds is not None:
        for p, (start, heal) in enumerate(arrays.part_bounds):
            if start <= int(k) < heal:
                return arrays.part_comp[p].to(torch.int32)
    return torch.zeros(arrays.m, dtype=torch.int32, device=arrays.nbrs.device)


# columns of a leaf `component_stats` takes at a time: a [5, 2^24] f32 block
# is 320 MB, where a whole full-width leaf would be 5.5 GB
STATS_COLS = 1 << 24


def _component_sums(comp: torch.Tensor, x: torch.Tensor, n_comp: int):
    """(Σ_i ||x_i − x̄_comp(i)||², [C] ||x̄_c − x̄||², [C] counts) of one
    [m, n] block, in f32."""
    x = x.reshape(x.shape[0], -1).to(torch.float32)
    onehot = (comp.to(x.device)[:, None] == torch.arange(n_comp, device=x.device)[None, :]
              ).to(torch.float32)
    counts = onehot.sum(dim=0)
    means = (onehot.T @ x) / torch.clamp(counts, min=1.0)[:, None]
    within = torch.sum((x - means[comp.long().to(x.device)]) ** 2)
    gap2 = torch.sum((means - x.mean(dim=0)) ** 2, dim=1)
    return within, gap2, counts


def component_stats(comp: torch.Tensor, x, n_comp: int, lanes: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(comp_consensus, comp_mean_gap) of the node-stacked parameters:
    the mean over nodes of ||x_i − x̄_comp(i)||² (within-component
    disagreement) and the largest ||x̄_c − x̄_global||₂ over non-empty
    components (the drift a split builds up).  ``x`` is one [m, n] matrix,
    as in JAX, or a list of [m, ...] leaves, whose sums are accumulated
    leaf by leaf and STATS_COLS columns at a time, so that neither a
    concatenated copy nor an f32 copy of a whole leaf is made (equal to the
    concatenated form up to the order of the f32 additions).  With
    ``lanes=L`` the leaves' rows are L lanes' ([L·m, ...], `comp` [L·m])
    and each statistic comes back [L], each lane's as its unbatched run
    computes it."""
    leaves = [x] if isinstance(x, torch.Tensor) else list(x)
    if lanes is not None:
        m = leaves[0].shape[0] // lanes
        per = [component_stats(comp[sl], [leaf[sl] for leaf in leaves], n_comp)
               for sl in (slice(lane * m, (lane + 1) * m) for lane in range(lanes))]
        return torch.stack([c for c, _ in per]), torch.stack([g for _, g in per])
    m = leaves[0].shape[0]
    within = gap2 = counts = None
    for b in (blk for leaf in leaves
              for blk in leaf.reshape(m, -1).split(STATS_COLS, dim=1)):
        w, g, c = _component_sums(comp, b, n_comp)
        within = w if within is None else within + w
        gap2 = g if gap2 is None else gap2 + g
        counts = c
    gap = torch.sqrt(gap2)
    return within / m, torch.max(torch.where(counts > 0, gap, torch.zeros_like(gap)))


def realization_matrix(arrays: ScenarioArrays, r: Realization) -> torch.Tensor:
    """The realized [m, m] matrix (row i = receiver i, CPU f32), [L, m, m]
    for a folded realization.  Padding slots carry weight 0 and scatter
    onto the diagonal as no-ops."""
    if arrays.lanes is not None:
        m = arrays.m // arrays.lanes
        return torch.stack([
            realization_matrix(arrays._replace(nbrs=arrays.nbrs[sl] - sl.start,
                                               nbrs_full=arrays.nbrs_full[sl] - sl.start,
                                               lanes=None),
                               r._replace(weights=r.weights[sl]))
            for sl in (slice(lane * m, (lane + 1) * m) for lane in range(arrays.lanes))])
    m = arrays.m
    rows = torch.arange(m)[:, None].expand(arrays.nbrs_full.shape)
    b = torch.zeros((m, m), dtype=torch.float32)
    return b.index_put_((rows, arrays.nbrs_full.cpu()), r.weights.cpu().to(torch.float32),
                        accumulate=True)


def scenario_mixer(arrays: ScenarioArrays, r: Realization, mode: str = "sparse",
                   impl: Optional[str] = None) -> Mixer:
    """One step's realization as a gossip `Mixer` on `arrays`' device
    (pass `arrays.to(device)`; the weights follow).  "sparse" gathers over
    the padded neighbours-then-self slots through `mixing.gather_terms`
    (the gossip kernel on the card); "dense" / "matrix" build the [m, m]
    realized matrix.  A folded realization gives a mixer over its L·m
    rows: the lane-offset table (sparse, one launch a leaf for all
    lanes), the lanes' [m, m] blocks side by side (dense), or each lane
    contracted by its own [m, m] matrix (matrix)."""
    dev = arrays.nbrs.device
    lanes = arrays.lanes or 1
    if mode == "sparse":
        # structural padding of the base table; the self slot is real
        pad = torch.cat([~arrays.valid, torch.zeros((arrays.m, 1), dtype=torch.bool,
                                                     device=dev)], dim=1)
        pm = PaddedMixing(arrays.nbrs_full, r.weights.to(dev, torch.float32),
                          arrays.is_self, pad)
        return Mixer("sparse", None, pm, impl, lanes)
    b = realization_matrix(arrays, r).to(dev)
    if mode == "dense":
        if arrays.lanes is None:
            return Mixer("dense", b, _dense_padded(b), impl)
        pm = fold_padded(_dense_padded(b[0]), lanes)
        pm = pm._replace(w=torch.cat([_dense_padded(bl).w for bl in b]))
        return Mixer("dense", b, pm, impl, lanes)
    if mode == "matrix":
        return Mixer("matrix", b, lanes=lanes)
    raise ValueError(f"unknown scenario mixing mode {mode!r}")


def _frozen(x, r: int) -> bool:
    """A leaf `freeze_dropped` restores: floating, with a leading node axis
    of the r node rows the state holds (all m unsharded)."""
    return (isinstance(x, torch.Tensor) and x.dim() >= 1 and x.shape[0] == r
            and x.is_floating_point())


def dropped_rows(alive: torch.Tensor, state,
                 shardings=None) -> List[Tuple[int, int, torch.Tensor]]:
    """Copies of the dropped nodes' rows of every floating per-node leaf
    of `state`, as (leaf index, node, row): what `restore_rows` puts back.
    Only the dropped rows are copied, never the whole state.  With
    `shardings` (a `sharding.MeshShardings` or a rank's `Local` view) the
    state holds this rank's rows r0 ... r0 + r - 1 and pieces, and the
    dropped nodes among them are copied (node i from its local row
    i - r0); a floating leaf that holds all m rows where the rank holds
    r < m raises, as JAX's arrays are whole where the port's are pieces."""
    alive = alive.cpu()
    m = alive.shape[0]
    mine = shd.node_rows(shardings, m)
    r = mine.stop - mine.start
    leaves = tree_flatten(state)[0]
    if r < m and any(_frozen(x, m) for x in leaves):
        raise ValueError(f"a state leaf holds all {m} node rows, but this rank holds "
                         f"rows {mine.start} ... {mine.stop - 1}: pass the rank's pieces")
    gone = [i for i in range(mine.start, mine.stop) if not bool(alive[i])]
    return [(idx, i, x[i - mine.start].clone()) for idx, x in enumerate(leaves)
            if _frozen(x, r) for i in gone]


def restore_rows(rows: List[Tuple[int, int, torch.Tensor]], state, shardings=None):
    """Write rows saved by `dropped_rows` back into `state`'s leaves, in
    place, and return the state.  A leaf the step did not replace (an
    in-place step's) gets its own pre-step rows back; a new leaf gets
    them copied in.  `shardings` as `dropped_rows` took it: node i goes
    to the rank's local row i - r0."""
    if not rows:
        return state
    leaves, treedef = tree_flatten(state)
    ways = shd.node_ways(shardings)
    with torch.no_grad():
        for idx, i, row in rows:
            x = leaves[idx]
            x[i - shd.node_rows(shardings, x.shape[0] * ways).start].copy_(row)
    return tree_unflatten(treedef, leaves)


def freeze_dropped(alive: torch.Tensor, old_state, new_state, shardings=None):
    """Revert dropped nodes' per-node state: where `alive` is False, every
    floating leaf with a leading node axis gets `old_state`'s rows back,
    bit for bit; integer counters and keys advance.  `new_state`'s leaves
    are written in place.  (A bound step calls `dropped_rows` before the
    step and `restore_rows` after it, since a step may consume its input.)
    With `shardings` (a `sharding.MeshShardings` or a rank's `Local`
    view) both states hold this rank's rows and pieces (`alive` stays
    whole, [m]), as JAX's `freeze_dropped` acts on sharded arrays."""
    return restore_rows(dropped_rows(alive, old_state, shardings), new_state, shardings)


def expected_matrix(topo: Topology, scenario: Scenario, num_samples: int = 256,
                    k_offset: int = 0) -> np.ndarray:
    """Empirical E[B^k] over `num_samples` realizations (float64)."""
    arrays = make_scenario_arrays(topo, scenario)
    acc = np.zeros((topo.m, topo.m), np.float64)
    for k in range(k_offset, k_offset + num_samples):
        acc += realization_matrix(arrays, realize(scenario, arrays, k)).double().numpy()
    return acc / num_samples
