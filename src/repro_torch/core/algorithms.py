"""Algorithm registry for decentralized FL (port of `repro.core.algorithms`).

One contract for every registered algorithm:

  * :class:`Algorithm` — a named spec with a hyperparameter dataclass,
    ``init``/``step`` glue, per-step expected wire bits (Eq. (8)) and
    ``params_of`` for reading the node-stacked parameters out of a state;
  * :func:`register` / :func:`get_algorithm` / :func:`list_algorithms`;
  * :meth:`Algorithm.bind` — closes a spec over (grad_fn, topology, hps,
    mixing mode, device) and returns a :class:`BoundAlgorithm` whose
    ``step`` the engine runs.

PaME and the five baselines of Figs. 8–10 (D-PSGD, DFedSAM, CHOCO-SGD,
BEER, ANQ-NIDS) are registered; every bound baseline gossips through
``make_mixer(topo, mixing)`` on the bound device (``mixing="sparse"`` by
default, the gossip kernel on the card).  `Algorithm.bind` takes dynamic
networks as JAX's does: an i.i.d. `core.scenarios.Scenario`, a Markov
`core.temporal.TemporalScenario` with bounded staleness, or a
`core.faults.FaultModel` with per-receiver surrogate replicas for CHOCO,
BEER and ANQ-NIDS.  Serving pacing (`serve.events.ServePacing`) layers
the serve-while-train event clock over any of these but a temporal one:
a node whose request backlog passes its threshold defers its exchange
that round like a straggler.

:meth:`Algorithm.bind_batched` runs S seeds × C configs of one algorithm
as one lane-batched step (:class:`BatchedAlgorithm`, `core.lanes`): lane
(s, c) reproduces the unbatched ``bind(hps_c)`` run under seed s bit for
bit.  The lanes fold into the node axis and the exchange launches once a
leaf for all of them, on a static network and under a dynamic, temporal,
fault or paced one alike: there each lane draws its own network from its
own keys on the host, and the folded realization drives one step of all
lanes (`_NetworkSteps`, `core.scenarios.fold_arrays`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import baselines as B
from repro_torch.core import engine
from repro_torch.core import faults as flt_mod
from repro_torch.core import pame as pame_mod
from repro_torch.core import scenarios as scen_mod
from repro_torch.core import temporal as temp_mod
from repro_torch.core.compression import qsgd, rand_k
from repro_torch.core.mixing import Mixer, make_mixer
from repro_torch.core.pme import fold_in
from repro_torch.core.pme import leaf_rates as pme_leaf_rates
from repro_torch.core.pme import message_bits, tree_message_bits
from repro_torch.core.topology import Topology
from repro_torch.serve.events import PacedCarry, ServePacing
from repro_torch.tree import tree_leaves, tree_map

AnyScenario = Union[scen_mod.Scenario, temp_mod.TemporalScenario]

__all__ = [
    "Algorithm", "BoundAlgorithm", "BatchedAlgorithm", "AlgoContext",
    "register", "get_algorithm", "list_algorithms", "lane_finals",
    "PaMEHp", "DPSGDHp", "DFedSAMHp", "ChocoHp", "BeerHp", "AnqNidsHp",
]

# ---------------------------------------------------------------------------
# Per-algorithm hyperparameters.  PaME reuses its paper-Table-II config.
# ---------------------------------------------------------------------------
PaMEHp = pame_mod.PaMEConfig


@dataclasses.dataclass(frozen=True)
class DPSGDHp:
    lr: float = 0.1


@dataclasses.dataclass(frozen=True)
class DFedSAMHp:
    lr: float = 0.1
    rho: float = 0.05       # SAM ascent radius
    local_steps: int = 1


@dataclasses.dataclass(frozen=True)
class ChocoHp:
    lr: float = 0.05
    gossip_gamma: float = 0.3
    comp_frac: float = 0.3  # contractive rand-k keep fraction
    value_bits: int = 64


@dataclasses.dataclass(frozen=True)
class BeerHp:
    lr: float = 0.05
    gossip_gamma: float = 0.4
    comp_frac: float = 0.2
    value_bits: int = 64


@dataclasses.dataclass(frozen=True)
class AnqNidsHp:
    lr: float = 0.1
    qsgd_levels: int = 16


@dataclasses.dataclass(frozen=True)
class AlgoContext:
    """Everything a registered step needs beyond (state, batch)."""

    grad_fn: Callable
    topo: Topology
    hps: object
    mixer: Mixer
    extras: dict


@dataclasses.dataclass(frozen=True)
class Algorithm:
    """A registered DFL algorithm: ``init(key, params_stacked, ctx, batch0)``,
    ``step(state, batch, ctx) -> (state, metrics)`` with a ``loss_mean``
    metric, ``wire_bits(topo, hps, n)`` expected bits per step."""

    name: str
    hp_cls: type
    init: Callable
    step: Callable
    wire_bits: Callable
    params_of: Callable = staticmethod(lambda s: s.params)
    needs_batch0: bool = False
    # optional (topo, hps, sizes) -> float: per-leaf Eq.-(8) accounting
    wire_bits_sizes: Optional[Callable] = None
    # optional (topo, hps, mixing, seed, device) -> dict merged into extras
    setup: Optional[Callable] = None
    # optional (hps, n) -> bits per realized *directed* edge per step: the
    # dynamic-network paths charge only surviving links with it
    edge_bits: Optional[Callable] = None
    # optional (hps) -> bool: the step consumes the delayed-delivery extras
    # itself (``fresh_params`` self-view, ``delivered`` masks) instead of
    # the wrapper's innovation re-add (PaME's memoryless dense exchange)
    handles_delay: Optional[Callable] = None
    # optional replicated variants for fault-injected binds:
    # ``rep_init(key, stacked, ctx, batch0, arrays)`` and
    # ``rep_step(state, batch, ctx)`` reading ``ctx.extras["fault"]``
    rep_init: Optional[Callable] = None
    rep_step: Optional[Callable] = None
    # hyperparameter fields that shape the step (payload sizes, loop
    # counts, wire formats): bind_batched refuses configs that differ in them
    static_hp_fields: Tuple[str, ...] = ()
    # fields realized by `setup` into per-config arrays (PaME's nu and
    # kappa_* -> TopologyArrays): configs may differ in them, each lane
    # taking its config's arrays
    setup_hp_fields: Tuple[str, ...] = ()

    def bind(
        self,
        grad_fn: Callable,
        topo: Topology,
        hps: Optional[object] = None,
        *,
        mixing: str = "sparse",
        seed: int = 0,
        scenario: Optional[AnyScenario] = None,
        faults: Optional[flt_mod.FaultModel] = None,
        pacing: Optional[ServePacing] = None,
        device=None,
    ) -> "BoundAlgorithm":
        """Close the spec over (grad_fn, topology, hps, mixing) on `device`
        (default ``cuda``).

        ``scenario=None`` or a static scenario binds the fixed-topology
        program, bit for bit.  A dynamic `Scenario` realizes each step's
        doubly stochastic matrix (``step(state, batch, k)``); a
        `TemporalScenario` also threads the Markov state and the staleness
        ring (``step(state, batch, k, aux) -> (state, metrics, aux)``,
        `aux_init`).  A non-static `FaultModel` layers message-level
        faults over the (possibly static) base scenario, with the temporal
        signature; a zero-rate one binds the fault-free program.  A
        non-static `ServePacing` threads the serve event clock through the
        carry too (`PacedCarry`, its ``inner`` slot the fault carry): each
        round's busy nodes OR into the straggler mask before the weights
        are built; a zero-rate pacing binds the unpaced program, bit for
        bit, and pacing on a `TemporalScenario` raises.
        """
        scenario, faults, pacing = _networks(scenario, faults, pacing)
        hps = self.hp_cls() if hps is None else hps
        if not isinstance(hps, self.hp_cls):
            raise TypeError(
                f"{self.name} expects {self.hp_cls.__name__}, got {type(hps).__name__}"
            )
        dev = resolve_device(device)
        extras = dict(self.setup(topo, hps, mixing, seed, dev)) if self.setup else {}
        if "hps" in extras:  # setup may rewrite hps (PaME's mixing field)
            hps = extras.pop("hps")
        mixer = make_mixer(topo, mixing, device=dev)
        ctx = AlgoContext(grad_fn=grad_fn, topo=topo, hps=hps, mixer=mixer,
                          extras=extras)
        if scenario is None:
            return BoundAlgorithm(self, ctx, dev)
        return BoundAlgorithm(self, ctx, dev, scenario=scenario,
                              scen_arrays=scen_mod.make_scenario_arrays(topo, scenario),
                              mixing_mode=mixing, faults=faults, pacing=pacing)

    def bind_batched(
        self,
        grad_fn: Callable,
        topo: Topology,
        hps_list: Optional[Sequence[object]] = None,
        *,
        seeds: Sequence[int] = (0,),
        mixing: str = "sparse",
        seed: int = 0,
        scenario: Optional[AnyScenario] = None,
        faults: Optional[flt_mod.FaultModel] = None,
        pacing: Optional[ServePacing] = None,
        device=None,
    ) -> "BatchedAlgorithm":
        """Close the spec over S seeds × C configs as ONE lane-batched step
        on `device` (default ``cuda``).

        Lane order is config-major, ``lane = c·S + s``; lane (s, c)
        reproduces the unbatched ``bind(hps_c)`` run started from key s,
        bit for bit.  A field named in ``static_hp_fields`` shapes the step
        and must be equal across `hps_list` (differing values raise); one in
        ``setup_hp_fields`` is realized per config by ``setup`` (PaME's t_i
        and kappa_i); a float field becomes a per-lane value; any other
        field that differs raises.

        A dynamic `scenario`, a `faults` model or a `pacing` folds each
        lane's seed into its key (`pme.fold_in`), as JAX does: the same
        seed under different configs sees the same sample path, different
        seeds different ones.  Faults or pacing on a `TemporalScenario`
        raise, as in `bind`.
        """
        scenario, faults, pacing = _networks(scenario, faults, pacing)
        hps_list = [self.hp_cls() if h is None else h for h in (hps_list or [None])]
        for h in hps_list:
            if not isinstance(h, self.hp_cls):
                raise TypeError(f"{self.name} expects {self.hp_cls.__name__}, "
                                f"got {type(h).__name__}")
        seeds = [int(s_) for s_ in seeds]
        if not seeds:
            raise ValueError("bind_batched needs at least one seed")
        dev = resolve_device(device)
        extras_list, eff_hps = [], []
        for h in hps_list:
            extras = dict(self.setup(topo, h, mixing, seed, dev)) if self.setup else {}
            if "hps" in extras:  # setup may rewrite hps (PaME's mixing field)
                h = extras.pop("hps")
            extras_list.append(extras)
            eff_hps.append(h)
        # classify differing fields: static -> refuse, setup-realized ->
        # per-config extras, float -> per-lane value
        swept: dict = {}
        for field in dataclasses.fields(self.hp_cls):
            vals = [getattr(h, field.name) for h in eff_hps]
            if all(v == vals[0] for v in vals[1:]):
                continue
            if field.name in self.static_hp_fields:
                raise ValueError(
                    f"{self.name}: hp field {field.name!r} shapes the traced program and "
                    f"must be equal across batched configs (got {vals})")
            if field.name in self.setup_hp_fields:
                continue
            if isinstance(vals[0], float) and not isinstance(vals[0], bool):
                swept[field.name] = vals
                continue
            raise ValueError(
                f"{self.name}: cannot batch over non-float hp field {field.name!r} "
                f"(got {vals}); sweep it across separate binds instead")
        return BatchedAlgorithm(self, grad_fn, topo, eff_hps, seeds, swept, extras_list, dev,
                                mixing_mode=mixing, scenario=scenario, faults=faults,
                                pacing=pacing)


def _networks(scenario, faults, pacing):
    """The network a bind realizes: (scenario, faults, pacing) with a
    zero-rate fault model or pacing dropped (the fault-free or unpaced
    program, bit for bit), a static base scenario under faults or pacing,
    and a static scenario alone dropped (the fixed-topology program).
    Faults or pacing on a `TemporalScenario`, and objects of other types,
    raise."""
    for what, obj, kinds in (("scenario", scenario, (scen_mod.Scenario,
                                                     temp_mod.TemporalScenario)),
                             ("faults", faults, (flt_mod.FaultModel,)),
                             ("pacing", pacing, (ServePacing,))):
        if obj is not None and not isinstance(obj, kinds):
            raise NotImplementedError(
                f"{what}={type(obj).__name__} is not a repro_torch "
                f"{' / '.join(k.__name__ for k in kinds)}"
            )
    if faults is not None and faults.is_static:
        faults = None  # zero-rate model == the fault-free program
    if pacing is not None and pacing.is_static:
        pacing = None  # zero-rate process == the unpaced program
    if faults is not None or pacing is not None:
        if isinstance(scenario, temp_mod.TemporalScenario):
            what = "faults" if faults is not None else "pacing"
            raise NotImplementedError(
                f"{what} cannot stack on a TemporalScenario: fold the "
                "staleness into FaultModel(delay=..., max_delay=...) "
                "and the link/node dynamics into a base Scenario"
            )
        return (scenario if scenario is not None else scen_mod.Scenario(name="static"),
                faults, pacing)
    if scenario is not None and scenario.is_static:
        scenario = None  # static scenario == the fixed-topology program
    return scenario, None, None


def _n_coords(params) -> int:
    return sum(int(np.prod(tuple(x.shape[1:]))) for x in tree_leaves(params))


def _ring_of(aux):
    """The staleness ring inside a carry (None without one)."""
    if isinstance(aux, PacedCarry):
        return None if aux.inner is None else aux.inner.ring
    return aux.ring


def _with_ring(aux, ring):
    """The carry with its staleness ring replaced."""
    if isinstance(aux, PacedCarry):
        return aux if aux.inner is None else aux._replace(inner=aux.inner._replace(ring=ring))
    return aux._replace(ring=ring)


def _fold_ring(r: torch.Tensor) -> torch.Tensor:
    """A lane-batched ring leaf [L, D, m, ...] as [D, L·m, ...]: a view of
    the storage `_unfold_ring` lays out (a copy after an engine select
    rebuilt it)."""
    return r.transpose(0, 1).reshape((r.shape[1], -1) + tuple(r.shape[3:]))


def _unfold_ring(r: torch.Tensor, lanes: int) -> torch.Tensor:
    """A [D, L·m, ...] ring leaf viewed lane first, [L, D, m, ...], as the
    engine's lane-wise selects and restores expect every carry leaf."""
    return r.view((r.shape[0], lanes, -1) + tuple(r.shape[2:])).transpose(0, 1)


class _NetworkSteps:
    """The step wrappers of a dynamic, temporal, fault or paced bind,
    shared by `BoundAlgorithm` (one lane: a state over m rows) and
    `BatchedAlgorithm` (L lanes folded over L·m rows).

    What is drawn stays per lane, on the host: each lane's [m, d] masks
    from its own key (`scenarios.sample_masks`), its Markov chains, its
    fault carry and its event clock.  The realization they give is folded
    over the state's rows (`scenarios.fold_arrays`), so the exchange, the
    local steps, the dropped rows' freeze and restore, the delayed rows'
    substitution and re-add, and the replica mix each touch the parameter
    stack once for all lanes.  Per-lane metrics are scalars for one lane,
    [L] for L.

    The realizations are built on the host, so the wrappers know which
    rows are dropped or delayed without reading the card: they copy a
    dropped row aside before the step and put it back after it, and
    substitute a delayed row's ring snapshot into the parameter stack in
    place (the step consumes that stack, as JAX's scan consumes its carry),
    keeping the fresh rows in the ring's slot k mod D, which they
    overwrite first.

    A class using it provides ``spec``, ``ctx``, ``scenario``, ``faults``,
    ``pacing``, ``_mixing_mode``, ``_lanes`` (None for one lane, else L),
    ``_lane_nets()`` (each lane's scenario arrays, fault key and pace key),
    ``_arrays`` (the arrays over the state's rows, on the host) and
    ``_arrays_dev`` (their copy on the run's device).
    """

    @property
    def name(self) -> str:
        return self.spec.name

    @property
    def dynamic(self) -> bool:
        """True when a non-static scenario or a fault model is bound (the
        step takes k)."""
        return self.scenario is not None

    @property
    def temporal(self) -> bool:
        return isinstance(self.scenario, temp_mod.TemporalScenario)

    @property
    def faulty(self) -> bool:
        return self.faults is not None

    @property
    def paced(self) -> bool:
        """True when a non-static ServePacing is bound (the step threads the
        event clock through the carry)."""
        return self.pacing is not None

    @property
    def carries_aux(self) -> bool:
        return self.temporal or self.faulty or self.paced

    @property
    def params_of(self) -> Callable:
        return self.spec.params_of

    # -- per-lane carries ----------------------------------------------------
    def _ring_depth(self) -> int:
        if self.faulty:
            return self.faults.max_delay
        return self.scenario.staleness if self.temporal else 0

    def _lane_carry(self, arrays, fault_key, pace_key, u=None):
        """One lane's carry without its ring: the fault state, the chains'
        state or the event clock around the fault state."""
        inner = None
        if self.faulty:
            inner = flt_mod.FaultCarry(flt_mod.fault_state_init(self.faults, arrays, fault_key,
                                                                u=u), None)
        if self.paced:
            return PacedCarry(events=self.pacing.init(arrays.m, pace_key), inner=inner)
        if inner is not None:
            return inner
        return temp_mod.TemporalCarry(temp_mod.temporal_state_init(self.scenario, arrays, u=u),
                                      None)

    # -- per-lane values -----------------------------------------------------
    def _lane_sum(self, t: torch.Tensor) -> torch.Tensor:
        """A [rows, ...] tensor summed over each lane's rows: over all rows
        for one lane, [L, ...] for L."""
        if self._lanes is None:
            return t.sum(dim=0)
        return t.reshape((self._lanes, -1) + tuple(t.shape[1:])).sum(dim=1)

    def _lane_stack(self, vals: list):
        """Per-lane values: the one value for one lane, stacked [L] for L."""
        if self._lanes is None:
            return vals[0]
        return torch.stack([torch.as_tensor(v) for v in vals])

    def _folded(self, rs: list, fold: Callable):
        return rs[0] if self._lanes is None else fold(rs)

    def _step_ctx(self, mixer: Mixer, extras: dict, draws: list) -> AlgoContext:
        """The step's context: its mixer and extras, and the algorithm's
        own draws (each lane's ``draws[l]["algo"]``, folded for L lanes)."""
        ex = dict(extras)
        algo = (draws[0].get("algo") if self._lanes is None
                else _fold_draws([d.get("algo") for d in draws]))
        if algo is not None:
            ex["draws"] = algo
        return dataclasses.replace(self.ctx, mixer=mixer, extras=ex)

    # -- the wrappers' pieces -----------------------------------------------
    def _mixer(self, r: scen_mod.Realization) -> Mixer:
        return scen_mod.scenario_mixer(self._arrays_dev, r, self._mixing_mode,
                                       impl=self.ctx.mixer.impl)

    def _realized_metrics(self, r: scen_mod.Realization, state, metrics: dict) -> dict:
        """Algorithms without their own per-message metric are charged
        edge_bits on every realized directed edge."""
        if "wire_bits" not in metrics:
            eb = (self.spec.edge_bits(self.ctx.hps, _n_coords(self.spec.params_of(state)))
                  if self.spec.edge_bits else 0.0)
            metrics["wire_bits"] = r.directed_edges.to(torch.float32) * float(eb)
        metrics["alive_nodes"] = self._lane_sum(r.alive).to(torch.int32)
        return metrics

    def _partition_metrics(self, k: int, new_state, metrics: dict) -> dict:
        """Within-component consensus and the between-component mean gap
        while the scenario schedules partition windows (nothing otherwise);
        accumulated leaf by leaf, lane by lane."""
        if not getattr(self.scenario, "partitions", ()):
            return metrics
        comp = scen_mod.active_components(self._arrays, k)
        cc, gap = scen_mod.component_stats(
            comp, tree_leaves(self.spec.params_of(new_state)), self.scenario.max_parts,
            lanes=self._lanes)
        metrics["comp_consensus"] = cc
        metrics["comp_mean_gap"] = gap
        return metrics

    def _handles_delay(self) -> bool:
        return self.spec.handles_delay is not None and self.spec.handles_delay(self.ctx.hps)

    def _substitute_delayed(self, state, ring, k: int, delayed: torch.Tensor,
                            tau: torch.Tensor, d_max: int, need_shift: bool):
        """JAX's ``eff = ring_gather(ring, fresh, (k − τ) mod D, delayed)``
        and ``ring_push(ring, fresh, k)``, moving only what differs, one
        pass a leaf for every lane: the delayed rows' snapshots are
        gathered (a copy, so a τ = D snapshot in slot k mod D survives the
        push), the fresh stack is pushed into slot k mod D, and the delayed
        rows of the parameter stack are overwritten with their snapshots in
        place.  `delayed` and `tau` live on the host, so the rows are known
        without reading the card; their indices go to the card in one
        asynchronous copy a step.  Returns (fresh, the slot-k-mod-D views of
        the fresh parameters; shift, a `GradShift` of fresh − delayed rows
        for the delayed rows, when asked)."""
        push = k % d_max
        nodes = [int(i) for i in torch.nonzero(delayed.cpu()).flatten()]
        leaves = tree_leaves(self.spec.params_of(state))
        shifts, where = [], None
        if nodes:
            where = torch.tensor([nodes, [(k - int(tau[i])) % d_max for i in nodes]],
                                 dtype=torch.int64).to(leaves[0].device, non_blocking=True)
        with torch.no_grad():
            for x, r in zip(leaves, tree_leaves(ring)):
                if nodes:
                    eff = r[where[1], where[0]]
                    if need_shift:
                        shifts.append(x[where[0]] - eff)
                r[push].copy_(x)
                if nodes:
                    x.index_copy_(0, where[0], eff)
                    del eff
        fresh = tree_map(lambda r: r[push], ring)
        if not (need_shift and nodes):
            return fresh, None
        return fresh, B.GradShift.from_stacked(nodes, where[0], shifts)

    def _readd(self, new_state, shift: Optional["B.GradShift"]):
        """Each delayed row re-adds its private innovation (fresh −
        delayed): p + (f − e), one pass a leaf."""
        if shift is None:
            return new_state
        leaves = tree_leaves(self.spec.params_of(new_state))
        with torch.no_grad():
            for p, d in zip(leaves, shift.stacked):
                p.index_copy_(0, shift.index, p[shift.index] + d.to(p.dtype))
        return new_state

    def _run_step(self, step_fn, state, batch, ctx_t, r, delayed, tau, d_max, ring, k):
        """The shared body of the temporal and fault steps: rows of dropped
        nodes aside, delayed rows substituted, the step, innovations
        re-added, dropped rows back."""
        frozen = scen_mod.dropped_rows(r.alive, state)
        shift = None
        if d_max > 0:
            hd = self._handles_delay()
            fresh, shift = self._substitute_delayed(state, ring, k, delayed, tau, d_max,
                                                    need_shift=not hd)
            if hd:
                ctx_t.extras["fresh_params"] = fresh
            elif shift is not None:
                ctx_t.extras["grad_shift"] = shift
        new_state, metrics = step_fn(state, batch, ctx_t)
        new_state = self._readd(new_state, shift)
        return scen_mod.restore_rows(frozen, new_state), metrics

    def _lane_masks(self, k: int, draws: list, busy: Optional[list]) -> list:
        """Each lane's step-k (edge_up, alive, straggler) masks from its own
        key, its busy nodes (pacing) ORed into the stragglers."""
        out = []
        for lane, ((arrays, _, _), d) in enumerate(zip(self._lane_nets(), draws)):
            edge_up, alive, straggler = scen_mod.sample_masks(self.scenario, arrays, k,
                                                              u=d.get("scenario"))
            if busy is not None:
                straggler = straggler | busy[lane]
            out.append((edge_up, alive, straggler))
        return out

    # -- the step wrappers ------------------------------------------------
    def _net_step(self, state, batch, k: int, carries: list, ring, draws: list):
        """One step of every lane under the bound network: ``carries`` holds
        each lane's carry without its ring, ``ring`` the staleness ring
        folded over the state's rows.  Returns (state, metrics, each lane's
        new carry without its ring); the ring is updated in place."""
        busy = events = None
        inner = carries
        if self.paced:
            events = [self.pacing.advance(c.events, k, u=d.get("pacing"))
                      for c, d in zip(carries, draws)]
            busy = [b for _, b, _ in events]
            inner = [c.inner for c in carries]
        if self.faulty:
            new_state, metrics, new_inner = self._fault_step(state, batch, k, inner, ring,
                                                             draws, busy)
        elif self.temporal:
            new_state, metrics, new_inner = self._temporal_step(state, batch, k, inner, ring,
                                                                draws)
        else:
            new_state, metrics = self._dynamic_step(state, batch, k, draws, busy)
            new_inner = [None] * len(carries)
        if not self.paced:
            return new_state, metrics, new_inner
        for key in events[0][2]:
            metrics[key] = self._lane_stack([m[key] for _, _, m in events])
        return new_state, metrics, [PacedCarry(e, i) for (e, _, _), i in zip(events, new_inner)]

    def _dynamic_step(self, state, batch, k: int, draws: list, busy: Optional[list] = None):
        """One step under the bound i.i.d. scenario: step k's realization
        (each lane's masks, the weights built over all rows at once), its
        mixer in the context, dropped nodes' state restored, realized edges
        charged on the wire.  ``busy`` (the pacing layer's busy masks) ORs
        into the straggler draws before the weights are built."""
        masks = self._lane_masks(k, draws, busy)
        r = scen_mod.realization_from_masks(self._arrays, *(torch.cat(m) for m in zip(*masks)))
        ctx_t = self._step_ctx(self._mixer(r), {**self.ctx.extras, "realization": r}, draws)
        frozen = scen_mod.dropped_rows(r.alive, state)
        new_state, metrics = self.spec.step(state, batch, ctx_t)
        new_state = scen_mod.restore_rows(frozen, new_state)
        metrics = self._realized_metrics(r, state, metrics)
        return new_state, self._partition_metrics(k, new_state, metrics)

    def _temporal_step(self, state, batch, k: int, carries: list, ring, draws: list):
        """One step under the bound TemporalScenario: advance each lane's
        chains, realize the step with delayed stragglers participating
        through their ring snapshots (message-only delay: their gradients
        are taken at the fresh point through ``grad_shift``, and each
        re-adds its innovation afterwards; PaME's dense exchange takes the
        fresh view as ``fresh_params`` instead), then restore dropped
        nodes."""
        adv = [temp_mod.advance(self.scenario, arrays, c.ts, k, u=d.get("temporal"))
               for (arrays, _, _), c, d in zip(self._lane_nets(), carries, draws)]
        r = self._folded([a[1] for a in adv], scen_mod.fold_realizations)
        delayed, tau = (torch.cat([a[i] for a in adv]) for i in (2, 3))
        ctx_t = self._step_ctx(self._mixer(r), {**self.ctx.extras, "realization": r}, draws)
        d_max = self.scenario.staleness
        new_state, metrics = self._run_step(self.spec.step, state, batch, ctx_t, r, delayed,
                                            tau, d_max, ring, k)
        if d_max > 0:
            grid = torch.arange(d_max + 1, dtype=torch.int32)
            metrics["stale_hist"] = self._lane_sum(
                (tau[:, None] == grid[None, :]) & r.participating[:, None]).to(torch.float32)
            metrics["stale_nodes"] = self._lane_sum(delayed).to(torch.int32)
        metrics = self._realized_metrics(r, state, metrics)
        return new_state, metrics, [temp_mod.TemporalCarry(a[0], None) for a in adv]

    def _fault_step(self, state, batch, k: int, carries: list, ring, draws: list,
                    busy: Optional[list] = None):
        """One step under the bound FaultModel: each lane's base-scenario
        masks (a paced bind's busy nodes added to the stragglers), fault
        transition and per-direction losses, the per-receiver renormalized
        weights for direct parameter mixing, the replicated step
        (``rep_step``) where the algorithm has one, PaME's delivery masks,
        delayed delivery through the ring as on the temporal path, and
        crashed nodes frozen."""
        fm = self.faults
        outs = [flt_mod.advance_faults(fm, arrays, c.fs, fault_key, k, *mk,
                                       u=d.get("faults"))
                for (arrays, fault_key, _), c, d, mk in zip(
                    self._lane_nets(), carries, draws, self._lane_masks(k, draws, busy))]
        fr = self._folded([o[1] for o in outs], flt_mod.fold_realizations)
        r = fr.base
        use_rep = self.spec.rep_step is not None
        extras = {**self.ctx.extras, "realization": r, "fault": fr,
                  "fault_arrays": self._arrays, "delivered": fr.recv_ok,
                  "repair": fm.repair}
        if use_rep:
            extras["innov_bits"] = float(self.spec.edge_bits(
                self.ctx.hps, _n_coords(self.spec.params_of(state))))
        ctx_t = self._step_ctx(self._mixer(r._replace(weights=fr.weights)), extras, draws)
        new_state, metrics = self._run_step(
            self.spec.rep_step if use_rep else self.spec.step, state, batch, ctx_t, r,
            fr.delayed, fr.tau, fm.max_delay, ring, k)
        if fm.max_delay > 0:
            metrics["stale_nodes"] = self._lane_sum(fr.delayed).to(torch.int32)
        metrics = self._realized_metrics(r, state, metrics)
        metrics = self._partition_metrics(k, new_state, metrics)
        metrics["col_defect"] = fr.col_defect
        metrics["mean_drift"] = self._lane_stack([fs.drift for fs, _ in outs])
        metrics["dropped_msgs"] = fr.dropped.to(torch.float32)
        metrics["crashed_nodes"] = self._lane_stack([fs.crashed.sum().to(torch.int32)
                                                     for fs, _ in outs])
        return new_state, metrics, [flt_mod.FaultCarry(fs, None) for fs, _ in outs]


class BoundAlgorithm(_NetworkSteps):
    """An Algorithm closed over (grad_fn, topology, hps, mixer).

    Without a dynamic scenario, ``step(state, batch)`` is a plain closure
    the engine runs.  A dynamic `Scenario` makes it ``step(state, batch,
    k)``; a `TemporalScenario`, a `FaultModel` or a `ServePacing`
    ``step(state, batch, k, aux) -> (state, metrics, aux)`` with the carry
    of `aux_init`.  Every form takes ``draws=`` (keys "scenario",
    "temporal", "faults", "pacing": the draws of `scenarios.sample_masks`,
    `temporal.advance`, `faults.advance_faults` and `ServePacing.advance`;
    "algo": the algorithm step's own draws), which is how the parity tests
    feed it the JAX package's.  The network steps are `_NetworkSteps`'
    with one lane.
    """

    def __init__(self, spec: Algorithm, ctx: AlgoContext, device: torch.device,
                 scenario: Optional[AnyScenario] = None,
                 scen_arrays: Optional[scen_mod.ScenarioArrays] = None,
                 mixing_mode: str = "sparse",
                 faults: Optional[flt_mod.FaultModel] = None,
                 pacing: Optional[ServePacing] = None,
                 fault_key: Optional[int] = None, pace_key: Optional[int] = None):
        self.spec = spec
        self.ctx = ctx
        self.device = device
        self.scenario = scenario
        self.scen_arrays = scen_arrays
        self._arrays_dev = None if scen_arrays is None else scen_arrays.to(device)
        self._mixing_mode = mixing_mode
        self._lanes = None
        self.faults = faults
        if faults is not None and fault_key is None:
            fault_key = int(faults.seed)
        self.fault_key = fault_key
        self.pacing = pacing
        if pacing is not None and pace_key is None:
            pace_key = int(pacing.process.seed)
        self.pace_key = pace_key

    @property
    def hps(self) -> object:
        return self.ctx.hps

    @property
    def _arrays(self) -> scen_mod.ScenarioArrays:
        return self.scen_arrays

    def _lane_nets(self) -> list:
        return [(self.scen_arrays, self.fault_key, self.pace_key)]

    def init(self, key: int, params_stacked, batch0=None):
        if self.spec.needs_batch0 and batch0 is None:
            raise ValueError(f"{self.name} needs batch0 at init")
        if self.faulty and self.spec.rep_init is not None:
            return self.spec.rep_init(key, params_stacked, self.ctx, batch0, self.scen_arrays)
        return self.spec.init(key, params_stacked, self.ctx, batch0)

    def aux_init(self, state, *, u: Optional[dict] = None):
        """The initial carry: a `FaultCarry` for a fault bind, a
        `TemporalCarry` (stationary Markov draws, the staleness ring seeded
        with the state's parameters) for a temporal one, and for a paced
        one a `PacedCarry` of a fresh event clock around the fault carry
        (None without faults).  ``u`` injects the stationary draws."""
        if not self.carries_aux:
            raise TypeError(f"{self.name} is not bound to a TemporalScenario")
        carry = self._lane_carry(self.scen_arrays, self.fault_key, self.pace_key, u)
        return _with_ring(carry, temp_mod.ring_init(self.spec.params_of(state),
                                                    self._ring_depth()))

    def _ctx(self, draws: Optional[dict] = None) -> AlgoContext:
        return self._step_ctx(self.ctx.mixer, self.ctx.extras, [draws or {}])

    def step(self, state, batch, k: Optional[int] = None, aux=None, *,
             draws: Optional[dict] = None):
        draws = draws or {}
        if not self.dynamic:
            return self.spec.step(state, batch, self._ctx(draws))
        if k is None:
            raise TypeError(
                f"{self.name} is bound to scenario {self.scenario.name!r}: "
                "step(state, batch, k) needs the global step index"
            )
        if self.carries_aux and aux is None:
            what = ("PacedCarry" if self.paced else "FaultCarry" if self.faulty
                    else "TemporalCarry")
            raise TypeError(f"{self.name}: step(state, batch, k, aux) needs the {what} "
                            "(see aux_init)")
        ring = None if aux is None else _ring_of(aux)
        carry = None if aux is None else _with_ring(aux, None)
        new_state, metrics, new = self._net_step(state, batch, int(k), [carry], ring, [draws])
        if not self.carries_aux:
            return new_state, metrics
        return new_state, metrics, _with_ring(new[0], ring)

    # -- accounting and drivers -------------------------------------------
    def wire_bits(self, n: int) -> float:
        """Expected bits on the wire per step, summed over the network."""
        return float(self.spec.wire_bits(self.ctx.topo, self.ctx.hps, n))

    def wire_bits_for(self, params0) -> float:
        """Expected bits/step for a concrete model pytree (per-leaf
        accounting where the algorithm registers it)."""
        sizes = tuple(int(np.prod(tuple(x.shape))) for x in tree_leaves(params0))
        if self.spec.wire_bits_sizes is not None:
            return float(self.spec.wire_bits_sizes(self.ctx.topo, self.ctx.hps, sizes))
        return self.wire_bits(sum(sizes))

    def stack_params(self, params0, m: int):
        return B.stack_params(tree_map(lambda x: x.to(self.device), params0), m)

    def _batches(self, batch_fn):
        return lambda k: tree_map(lambda x: x.to(self.device), batch_fn(k))

    def _start(self, key, params0, m, batch_fn):
        batch0 = batch_fn(0) if self.spec.needs_batch0 else None
        state = self.init(key, self.stack_params(params0, m), batch0)
        return state, (self.aux_init(state) if self.carries_aux else None)

    def make_runner(self, *, objective_fn=None, tol_std: float = 1e-3,
                    chunk_size: int = engine.DEFAULT_CHUNK_SIZE) -> Callable:
        """Persistent chunked runner: ``run(key, params0, m, batch_fn,
        num_steps) -> (state, history)``."""
        runner = engine.make_scan_runner(
            self.step, objective_fn=objective_fn, params_of=self.spec.params_of,
            tol_std=tol_std, chunk_size=chunk_size, step_takes_index=self.dynamic,
            carries_aux=self.carries_aux,
        )

        def run(key, params0, m, batch_fn, num_steps):
            batch_fn = self._batches(batch_fn)
            state, aux = self._start(key, params0, m, batch_fn)
            box, state = engine.Donated(state), None  # freed after the first step
            state, metrics, info = runner(box, batch_fn, num_steps, aux=aux)
            history = {k: [float(v) for v in vals] for k, vals in metrics.items()
                       if k != "stale_hist"}
            if "stale_hist" in metrics:
                history["staleness_hist"] = engine.staleness_hist(metrics["stale_hist"])
            history["loss"] = history.pop("loss_mean", [])
            history.update({k: v for k, v in info.items() if k != "aux"})
            self._account_wire(history, params0)
            return state, history

        return run

    def run(self, key, params0, m: int, batch_fn, num_steps: int, *,
            objective_fn=None, tol_std: float = 1e-3, driver: str = "scan",
            chunk_size: int = engine.DEFAULT_CHUNK_SIZE):
        """One-shot driver (scan or host), with wire accounting."""
        batch_fn = self._batches(batch_fn)
        state, aux = self._start(key, params0, m, batch_fn)
        state, history = B.run_algorithm(
            self.step, state, batch_fn, num_steps, objective_fn=objective_fn,
            params_of=self.spec.params_of, tol_std=tol_std, driver=driver,
            chunk_size=chunk_size, step_takes_index=self.dynamic,
            carries_aux=self.carries_aux, aux=aux,
        )
        self._account_wire(history, params0)
        return state, history

    def _account_wire(self, history: dict, params0) -> None:
        per_step = history.get("wire_bits")
        if per_step:
            # dynamic network: only realized (surviving) edges were charged
            history["wire_bits_total"] = float(np.sum(per_step))
            history["wire_bits_per_step"] = history["wire_bits_total"] / max(len(per_step), 1)
            return
        history.pop("wire_bits", None)  # static runs keep the legacy schema
        history["wire_bits_per_step"] = self.wire_bits_for(params0)
        history["wire_bits_total"] = history["wire_bits_per_step"] * history["steps_run"]


def _lane_of(tree, lane: int):
    """Lane `lane` of a lane-stacked tree: tensors [L, ...] -> [...], int64
    arrays [L] -> Python ints."""

    def one(x):
        if isinstance(x, torch.Tensor):
            return x[lane]
        if isinstance(x, np.ndarray):
            return x[lane].item()
        return x

    return tree_map(one, tree)


def _stack_lanes(trees: list):
    """Per-lane trees stacked into one: tensors [L, ...], numbers int64 /
    float arrays [L]; None stays None."""

    def one(*xs):
        if isinstance(xs[0], torch.Tensor):
            return torch.stack(xs)
        if xs[0] is None:
            return None
        return np.asarray(xs)

    return tree_map(one, *trees)


def _fold(tree):
    """[L, m, ...] tensor leaves viewed as [L·m, ...]."""
    return tree_map(lambda x: x.reshape((-1,) + tuple(x.shape[2:]))
                    if isinstance(x, torch.Tensor) else x, tree)


def _unfold(tree, lanes: int):
    return tree_map(lambda x: x.reshape((lanes, -1) + tuple(x.shape[1:]))
                    if isinstance(x, torch.Tensor) else x, tree)


def _fold_draws(per_lane: list) -> Optional[dict]:
    """Per-lane algorithm draws (`BoundAlgorithm.step`'s ``draws["algo"]``
    format) folded over the lanes' rows: tensors and per-leaf lists
    concatenated, PaME's [m, m] selection ``a`` stacked [L, m, m]."""
    if not per_lane or per_lane[0] is None:
        return None
    out = {}
    for key, v0 in per_lane[0].items():
        vals = [d[key] for d in per_lane]
        if key == "a":
            out[key] = torch.stack([torch.as_tensor(v) for v in vals])
        elif isinstance(v0, (list, tuple)):
            out[key] = [torch.cat([torch.as_tensor(v[i]) for v in vals]) for i in range(len(v0))]
        else:
            out[key] = torch.cat([torch.as_tensor(v) for v in vals])
    return out


class BatchedAlgorithm(_NetworkSteps):
    """S seeds × C configs of one Algorithm as a single lane-batched step.

    Built by :meth:`Algorithm.bind_batched`.  State leaves are [L, m, ...]
    (lane = c·S + s), the step counter and key int64 [L]; ``step`` has the
    signature the engine expects of a lane-batched step, ``(state,
    batch[, k][, aux]) -> (state, metrics[, aux])`` with metrics [L], the
    batch and the global step index broadcast to every lane, plus
    ``draws=``: a list of L per-lane dicts in `BoundAlgorithm.step`'s
    format (how the parity tests feed each lane the reference's streams).

    The step views the leaves as [L·m, ...] and runs the algorithm once
    over them (`core.lanes`): per-lane keys, per-lane values of the swept
    fields, each lane's config's topology arrays, and a mixer over
    lane-offset tables, so each leaf's exchange is one launch for all
    lanes.  Under a dynamic scenario, a temporal one, faults or pacing the
    same holds (`_NetworkSteps`): each lane draws its masks, chains, fault
    carry and event clock from its own keys (its seed folded into the
    network, fault and pace keys), and the realization they give is folded
    over the L·m rows (`scenarios.fold_arrays`), with the staleness ring
    as [D, L·m, ...] (the carry shows it lane first, [L, D, m, ...]).

    ``run``/``make_runner`` drive it through ``engine.make_scan_runner(
    lanes=L)``: per-lane stopping, [steps, L] metric buffers and per-lane
    wire accounting; :func:`lane_finals` reads a buffer at each lane's
    own stopping step.
    """

    def __init__(self, spec: Algorithm, grad_fn: Callable, topo: Topology, hps_list: list,
                 seeds: list, swept: dict, extras_list: list, device: torch.device, *,
                 mixing_mode: str = "sparse", scenario: Optional[AnyScenario] = None,
                 faults: Optional[flt_mod.FaultModel] = None,
                 pacing: Optional[ServePacing] = None):
        self.spec = spec
        self.topo = topo
        self.hps_list = list(hps_list)
        self.seeds = list(seeds)
        self.device = device
        self.scenario = scenario
        self.faults = faults
        self.pacing = pacing
        self._mixing_mode = mixing_mode
        c, s_ = len(self.hps_list), len(self.seeds)
        self.lane_config = np.repeat(np.arange(c), s_)   # [L]
        self.lane_seed = np.asarray(self.seeds * c)      # [L]
        self._lanes = self.lanes
        # per-lane values of the swept fields, each lane's config's setup
        # arrays, the mixer's lane-offset tables
        hps = dataclasses.replace(self.hps_list[0], **{
            f: tuple(vals[cfg] for cfg in self.lane_config) for f, vals in swept.items()})
        extras = {}
        for key, v0 in extras_list[0].items():
            if isinstance(v0, pame_mod.TopologyArrays):
                extras[key] = pame_mod.fold_topology_arrays(
                    [extras_list[cfg][key] for cfg in self.lane_config])
            else:
                extras[key] = v0  # shared: equal across configs (static fields)
        self.ctx = AlgoContext(grad_fn=grad_fn, topo=topo, hps=hps,
                               mixer=make_mixer(topo, mixing_mode, device=device,
                                                lanes=self.lanes),
                               extras=extras)
        self.scen_arrays = (None if scenario is None
                            else scen_mod.make_scenario_arrays(topo, scenario))
        if self.dynamic:
            # each seed's network, fault and request sample paths, shared
            # across configs; the tables folded over the lanes' rows
            arrays = self.scen_arrays
            self._nets = [(arrays._replace(key=fold_in(arrays.key, s)),
                           None if faults is None else fold_in(int(faults.seed), s),
                           None if pacing is None else fold_in(int(pacing.process.seed), s))
                          for s in self.lane_seed]
            self._arrays = scen_mod.fold_arrays(arrays, self.lanes)
            self._arrays_dev = self._arrays.to(device)

    # -- grid geometry ------------------------------------------------------
    @property
    def lanes(self) -> int:
        return len(self.hps_list) * len(self.seeds)

    def _lane_nets(self) -> list:
        return self._nets

    # -- state and step -----------------------------------------------------
    def init(self, params0, m: int, batch0=None):
        """The lane-stacked initial state ([L, m, ...] leaves), lane l
        started from key ``lane_seed[l]``."""
        if self.spec.needs_batch0 and batch0 is None:
            raise ValueError(f"{self.name} needs batch0 at init")
        params0 = tree_map(lambda x: x.to(self.device), params0)
        stacked = B.stack_params(params0, self.lanes * m)
        keys = np.asarray(self.lane_seed, dtype=np.int64)
        if self.faulty and self.spec.rep_init is not None:
            state = self.spec.rep_init(keys, stacked, self.ctx, batch0, self._arrays)
        else:
            state = self.spec.init(keys, stacked, self.ctx, batch0)
        return _unfold(state, self.lanes)

    def aux_init(self, state, *, u: Optional[list] = None):
        """The lane-stacked auxiliary carry, each lane's from its own keys
        and the staleness ring seeded with the state's parameters; ``u``
        injects each lane's stationary draws (a list)."""
        if not self.carries_aux:
            raise TypeError(f"{self.name} carries no auxiliary state")
        aux = _stack_lanes([
            self._lane_carry(arrays, fault_key, pace_key, None if u is None else u[lane])
            for lane, (arrays, fault_key, pace_key) in enumerate(self._nets)])
        ring = temp_mod.ring_init(_fold(self.spec.params_of(state)), self._ring_depth())
        return _with_ring(aux, None if ring is None else tree_map(
            lambda r: _unfold_ring(r, self.lanes), ring))

    def step(self, state, batch, k: Optional[int] = None, aux=None, *,
             draws: Optional[list] = None):
        """One step of every lane; the batch and the global step index are
        shared by the lanes."""
        if not self.dynamic:
            ctx = self._step_ctx(self.ctx.mixer, self.ctx.extras, draws or [{}] * self.lanes)
            new_state, metrics = self.spec.step(_fold(state), batch, ctx)
            return _unfold(new_state, self.lanes), metrics
        draws = draws or [{}] * self.lanes
        ring = None if aux is None else _ring_of(aux)
        ring = None if ring is None else tree_map(_fold_ring, ring)
        bare = None if aux is None else _with_ring(aux, None)
        carries = [None if bare is None else _lane_of(bare, lane) for lane in range(self.lanes)]
        new_state, metrics, new = self._net_step(_fold(state), batch, int(k), carries, ring,
                                                 draws)
        new_state = _unfold(new_state, self.lanes)
        if not self.carries_aux:
            return new_state, metrics
        return new_state, metrics, _with_ring(_stack_lanes(new), None if ring is None else
                                              tree_map(lambda r: _unfold_ring(r, self.lanes),
                                                       ring))

    # -- accounting and drivers ---------------------------------------------
    def wire_bits(self, n: int) -> float:
        """Expected bits/step (network-wide) of config 0, the scalar the
        training log prints; per-lane accounting lives in the history."""
        return float(self.spec.wire_bits(self.topo, self.hps_list[0], n))

    def _wire_bits_sizes(self, hps, sizes) -> float:
        if self.spec.wire_bits_sizes is not None:
            return float(self.spec.wire_bits_sizes(self.topo, hps, sizes))
        return float(self.spec.wire_bits(self.topo, hps, sum(sizes)))

    def wire_bits_for(self, params0) -> float:
        """Config 0's expected bits/step for a concrete model pytree."""
        sizes = tuple(int(np.prod(tuple(x.shape))) for x in tree_leaves(params0))
        return self._wire_bits_sizes(self.hps_list[0], sizes)

    def _batches(self, batch_fn):
        return lambda k: tree_map(lambda x: x.to(self.device), batch_fn(k))

    def make_runner(self, *, objective_fn=None, tol_std: float = 1e-3,
                    chunk_size: int = engine.DEFAULT_CHUNK_SIZE) -> Callable:
        """Persistent lane-batched runner: ``run(params0, m, batch_fn,
        num_steps) -> (state, history)`` with [steps, L] metric buffers."""
        runner = engine.make_scan_runner(
            self.step, objective_fn=objective_fn, params_of=self.spec.params_of,
            tol_std=tol_std, chunk_size=chunk_size, step_takes_index=self.dynamic,
            carries_aux=self.carries_aux, lanes=self.lanes,
        )

        def run(params0, m, batch_fn, num_steps):
            batch_fn = self._batches(batch_fn)
            batch0 = batch_fn(0) if self.spec.needs_batch0 else None
            state = self.init(params0, m, batch0)
            aux = self.aux_init(state) if self.carries_aux else None
            box, state = engine.Donated(state), None  # freed after the first step
            state, metrics, info = runner(box, batch_fn, num_steps, aux=aux)
            return state, self._assemble_history(metrics, info, params0)

        return run

    def run(self, params0, m: int, batch_fn, num_steps: int, *, objective_fn=None,
            tol_std: float = 1e-3, chunk_size: int = engine.DEFAULT_CHUNK_SIZE):
        """One-shot batched grid run (see `make_runner`)."""
        return self.make_runner(objective_fn=objective_fn, tol_std=tol_std,
                                chunk_size=chunk_size)(params0, m, batch_fn, num_steps)

    def _assemble_history(self, metrics: dict, info: dict, params0) -> dict:
        """JAX's batched history: [steps, L] buffers (``loss`` from
        ``loss_mean``), ``steps_run`` [L], ``lane_config`` / ``lane_seed``,
        per-lane ``wire_bits_per_step`` / ``wire_bits_total`` and the
        per-lane ``staleness_hist`` [L, D+1], each lane cut at its own
        stopping step."""
        history = {k: np.asarray(v) for k, v in metrics.items() if k != "stale_hist"}
        steps_run = np.asarray(info["steps_run"])
        if "stale_hist" in metrics:
            rows = np.asarray(metrics["stale_hist"])
            history["staleness_hist"] = np.stack([
                rows[: steps_run[lane], lane].sum(axis=0) for lane in range(self.lanes)])
        if "loss_mean" in history:
            history["loss"] = history.pop("loss_mean")
        history["steps_run"] = steps_run
        history["steps_dispatched"] = info["steps_dispatched"]
        history["lane_config"] = self.lane_config
        history["lane_seed"] = self.lane_seed
        if "wire_bits" in history:
            # dynamic: per-step realized bits [steps, L], cut per lane
            per = history["wire_bits"]
            total = np.array([per[: steps_run[lane], lane].sum() for lane in range(self.lanes)])
            history["wire_bits_total"] = total
            history["wire_bits_per_step"] = total / np.maximum(steps_run, 1)
        else:
            sizes = tuple(int(np.prod(tuple(x.shape))) for x in tree_leaves(params0))
            per_cfg = np.array([self._wire_bits_sizes(h, sizes) for h in self.hps_list])
            history["wire_bits_per_step"] = per_cfg[self.lane_config]
            history["wire_bits_total"] = history["wire_bits_per_step"] * steps_run
        return history


def lane_finals(history: dict, key: str = "objective") -> np.ndarray:
    """Per-lane final value of a batched metric buffer: entry l is
    ``history[key][steps_run[l] - 1, l]``, each lane read at its own
    stopping step (the buffers run to the last dispatched chunk)."""
    buf = np.asarray(history[key])
    steps_run = np.asarray(history["steps_run"])
    return np.array([buf[max(int(steps_run[lane]) - 1, 0), lane]
                     for lane in range(buf.shape[1])])


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
_REGISTRY: dict = {}


def register(alg: Algorithm) -> Algorithm:
    if alg.name in _REGISTRY:
        raise ValueError(f"algorithm {alg.name!r} already registered")
    _REGISTRY[alg.name] = alg
    return alg


def get_algorithm(name: str) -> Algorithm:
    if name not in _REGISTRY:
        raise ValueError(f"unknown algorithm {name!r}; pick from {list(_REGISTRY)}")
    return _REGISTRY[name]


def list_algorithms() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


# ---------------------------------------------------------------------------
# Wire accounting helpers (Eq. (8) + per-algorithm message formats)
# ---------------------------------------------------------------------------
def _dense_edges_bits(topo: Topology, n: int, bits_per_msg: float) -> float:
    """Every node sends one message to every neighbor each step."""
    return float(topo.degrees.sum()) * bits_per_msg


# bits per *directed* edge per step for the gossip baselines
def _full_msg_bits(hps, n: int) -> float:
    return float(message_bits(n, n))


def _choco_edge_bits(hps, n: int) -> float:
    return float(rand_k(hps.comp_frac, hps.value_bits, rescale=False).bits(n))


def _beer_edge_bits(hps, n: int) -> float:
    # two compressed streams per edge per step (x and gradient surrogates)
    return 2.0 * _choco_edge_bits(hps, n)


def _anq_edge_bits(hps, n: int) -> float:
    return float(qsgd(hps.qsgd_levels).bits(n))


def _pame_msgs_per_step(topo: Topology, hps: PaMEHp) -> float:
    """Expected sparse messages on the wire per step: receiver i pulls t_i
    messages in the 1/kappa_i fraction of steps it communicates."""
    t = np.maximum(1, np.floor(hps.nu * topo.degrees))
    if hps.homogeneous_kappa is not None:
        inv_kappa = 1.0 / float(hps.homogeneous_kappa)
    else:
        ks = np.arange(hps.kappa_lo, hps.kappa_hi + 1, dtype=np.float64)
        inv_kappa = float(np.mean(1.0 / ks))
    return float(t.sum()) * inv_kappa


def _pame_wire_bits(topo: Topology, hps: PaMEHp, n: int) -> float:
    """Expected bits/step pricing one flat n-coordinate message of
    message_bits(s, n) per transmission."""
    s = max(1, int(round(hps.p * n)))
    value_bits = 8 if hps.exchange == "compressed_q8" else 64
    return _pame_msgs_per_step(topo, hps) * message_bits(s, n, value_bits)


def _pame_wire_bits_sizes(topo: Topology, hps: PaMEHp, sizes) -> float:
    """Flat partition keeps the single-vector formula; tree partition sums
    the per-leaf Eq.-(8) segments at their p_leaf rates."""
    if hps.partition != "tree":
        return _pame_wire_bits(topo, hps, sum(sizes))
    value_bits = 8 if hps.exchange == "compressed_q8" else 64
    rates = pme_leaf_rates(len(sizes), hps.p, hps.p_leaf)
    return _pame_msgs_per_step(topo, hps) * tree_message_bits(sizes, rates, value_bits)


def _pame_setup(topo, hps, mixing, seed, device):
    # the bind-level mixing mode governs the node-axis contraction
    mode = "sparse" if mixing == "sparse" else "dense"
    hps = dataclasses.replace(hps, mixing=mode)
    return {
        "hps": hps,
        "topo_arrays": pame_mod.make_topology_arrays(topo, hps, seed=seed, device=device),
    }


register(Algorithm(
    name="pame",
    hp_cls=PaMEHp,
    init=lambda key, stacked, ctx, batch0: pame_mod.pame_init(
        key, stacked, ctx.topo.m, ctx.hps),
    step=lambda state, batch, ctx: pame_mod.pame_step(
        state, batch, ctx.grad_fn, ctx.extras["topo_arrays"], ctx.hps,
        realization=ctx.extras.get("realization"),
        self_params=ctx.extras.get("fresh_params"),
        delivered=ctx.extras.get("delivered"), draws=ctx.extras.get("draws")),
    wire_bits=_pame_wire_bits,
    wire_bits_sizes=_pame_wire_bits_sizes,
    setup=_pame_setup,
    # the dense exchange takes message-only delay natively: senders
    # transmit the ring-delayed stack, the λ = 0 fill reads the fresh view
    handles_delay=lambda hps: hps.exchange == "dense",
    # p fixes the payload size s = round(p·n); nu and kappa_* are realized
    # into TopologyArrays by setup, one per config
    static_hp_fields=("p", "mask_mode", "exchange", "mixing", "partition", "p_leaf"),
    setup_hp_fields=("nu", "kappa_lo", "kappa_hi", "homogeneous_kappa"),
))


register(Algorithm(
    name="dpsgd",
    hp_cls=DPSGDHp,
    init=lambda key, stacked, ctx, batch0: B.dpsgd_init(key, stacked),
    step=lambda state, batch, ctx: B.dpsgd_step(
        state, batch, ctx.grad_fn, ctx.mixer, ctx.hps.lr,
        grad_shift=ctx.extras.get("grad_shift"), draws=ctx.extras.get("draws")),
    wire_bits=lambda topo, hps, n: _dense_edges_bits(topo, n, _full_msg_bits(hps, n)),
    edge_bits=_full_msg_bits,
))

register(Algorithm(
    name="dfedsam",
    hp_cls=DFedSAMHp,
    init=lambda key, stacked, ctx, batch0: B.dfedsam_init(key, stacked),
    step=lambda state, batch, ctx: B.dfedsam_step(
        state, batch, ctx.grad_fn, ctx.mixer, ctx.hps.lr,
        rho=ctx.hps.rho, local_steps=ctx.hps.local_steps,
        grad_shift=ctx.extras.get("grad_shift"), draws=ctx.extras.get("draws")),
    wire_bits=lambda topo, hps, n: _dense_edges_bits(topo, n, _full_msg_bits(hps, n)),
    edge_bits=_full_msg_bits,
    static_hp_fields=("local_steps",),  # the loop count of the local chain
))


def _choco_setup(topo, hps, mixing, seed, device):
    return {"comp": rand_k(hps.comp_frac, hps.value_bits, rescale=False)}


def _fault_args(ctx) -> tuple:
    """(realization, arrays, innovation bits, repair) of a fault step."""
    ex = ctx.extras
    return ex["fault"], ex["fault_arrays"], ex["innov_bits"], ex["repair"]


register(Algorithm(
    name="choco",
    hp_cls=ChocoHp,
    init=lambda key, stacked, ctx, batch0: B.choco_init(key, stacked),
    step=lambda state, batch, ctx: B.choco_step(
        state, batch, ctx.grad_fn, ctx.mixer, ctx.hps.lr,
        ctx.extras["comp"], ctx.hps.gossip_gamma,
        grad_shift=ctx.extras.get("grad_shift"), draws=ctx.extras.get("draws")),
    wire_bits=lambda topo, hps, n: _dense_edges_bits(topo, n, _choco_edge_bits(hps, n)),
    edge_bits=_choco_edge_bits,
    setup=_choco_setup,
    # the rand-k keep count round(frac·n) and the value width shape the payload
    static_hp_fields=("comp_frac", "value_bits"),
    rep_init=lambda key, stacked, ctx, batch0, arrays: flt_mod.rep_choco_init(
        key, stacked, arrays),
    rep_step=lambda state, batch, ctx: flt_mod.rep_choco_step(
        state, batch, ctx.grad_fn, ctx.hps.lr, ctx.extras["comp"], ctx.hps.gossip_gamma,
        *_fault_args(ctx), grad_shift=ctx.extras.get("grad_shift"),
        draws=ctx.extras.get("draws")),
))

register(Algorithm(
    name="beer",
    hp_cls=BeerHp,
    init=lambda key, stacked, ctx, batch0: B.beer_init(key, stacked, batch0, ctx.grad_fn),
    step=lambda state, batch, ctx: B.beer_step(
        state, batch, ctx.grad_fn, ctx.mixer, ctx.hps.lr,
        ctx.extras["comp"], ctx.hps.gossip_gamma,
        grad_shift=ctx.extras.get("grad_shift"), draws=ctx.extras.get("draws")),
    wire_bits=lambda topo, hps, n: _dense_edges_bits(topo, n, _beer_edge_bits(hps, n)),
    edge_bits=_beer_edge_bits,
    needs_batch0=True,
    setup=_choco_setup,
    static_hp_fields=("comp_frac", "value_bits"),
    rep_init=lambda key, stacked, ctx, batch0, arrays: flt_mod.rep_beer_init(
        key, stacked, batch0, ctx.grad_fn, arrays),
    rep_step=lambda state, batch, ctx: flt_mod.rep_beer_step(
        state, batch, ctx.grad_fn, ctx.hps.lr, ctx.extras["comp"], ctx.hps.gossip_gamma,
        *_fault_args(ctx), grad_shift=ctx.extras.get("grad_shift"),
        draws=ctx.extras.get("draws")),
))

register(Algorithm(
    name="anq_nids",
    hp_cls=AnqNidsHp,
    init=lambda key, stacked, ctx, batch0: B.nids_init(
        key, stacked, batch0, ctx.grad_fn, ctx.hps.lr),
    step=lambda state, batch, ctx: B.nids_step(
        state, batch, ctx.grad_fn, ctx.mixer, ctx.hps.lr, ctx.extras["q"],
        grad_shift=ctx.extras.get("grad_shift"), draws=ctx.extras.get("draws")),
    wire_bits=lambda topo, hps, n: _dense_edges_bits(topo, n, _anq_edge_bits(hps, n)),
    edge_bits=_anq_edge_bits,
    needs_batch0=True,
    setup=lambda topo, hps, mixing, seed, device: {"q": qsgd(hps.qsgd_levels)},
    static_hp_fields=("qsgd_levels",),  # the quantizer's wire format
    rep_init=lambda key, stacked, ctx, batch0, arrays: flt_mod.rep_nids_init(
        key, stacked, arrays),
    rep_step=lambda state, batch, ctx: flt_mod.rep_nids_step(
        state, batch, ctx.grad_fn, ctx.hps.lr, ctx.extras["q"], *_fault_args(ctx),
        grad_shift=ctx.extras.get("grad_shift"), draws=ctx.extras.get("draws")),
))
