"""PaME — Algorithm 1 of the paper (port of `repro.core.pame`).

All m nodes are simulated in one process: every state leaf carries a
leading node axis [m, ...].  Per-step randomness (neighbour selection,
coordinate masks, per-node keys) comes from seeds folded from the state's
integer key and step counter, so a run is reproducible and the scan and
host drivers draw the same numbers.  `pame_step(..., draws=)` takes the
draws instead, which is how the parity tests feed it the JAX package's.

Update rule (lines 4–14):
    k in K_i:  v_i = PME(w_i, {w_j : j in N_i^k}),  N_i^k ~ U(N_i, t_i)
    else:      v_i = w_i
    w_i^{k+1}  = v_i - grad f_i(v_i; B_i^k) / (sigma_i^k * t_i)
    sigma_i^{k+1} = gamma_i * sigma_i^k

The non-communicating branch zeroes the receiver's selection, which
drives every coordinate count to zero and makes PME return w_i exactly.

Lanes (`core.lanes`): given `LaneTopologyArrays` (one `TopologyArrays` a
lane and the lane-offset tables of all of them), `pame_step` steps L lanes
folded into [L·m, ...] leaves, the state's key, step and sigma per lane:
each lane draws its selection and masks from its own key on its own m-node
arrays, takes its own t_i, kappa_i and gamma, and reports its own metrics
([L]); the exchange is one call a leaf for all lanes.  On a dynamic
network the realization, the self view and the delivery masks are folded
over the same rows (`core.scenarios.fold_arrays`): each lane's receivers
are gated by its own rows of the realization, and its realized wire bits
come back [L].
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import engine, gossip, pme
from repro_torch.core import lanes as LN
from repro_torch.core.topology import Topology
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

__all__ = [
    "PaMEConfig", "PaMEState", "TopologyArrays", "LaneTopologyArrays",
    "make_topology_arrays", "fold_topology_arrays",
    "pame_init", "pame_step", "make_pame_runner", "run_pame",
]

# grad_fn(params_i, batch_i, key_i) -> (loss_i, grads_i); key_i is an int seed
# for node i's own randomness (the LM and regression losses ignore it)
GradFn = Callable[[object, object, int], Tuple[torch.Tensor, object]]


@dataclasses.dataclass(frozen=True)
class PaMEConfig:
    """Hyper-parameters of Algorithm 1 (paper Table II defaults)."""

    nu: float = 0.2          # participation rate nu_i
    p: float = 0.2           # transmission rate s/n
    gamma: float = 1.005     # penalty growth gamma_i > 1
    sigma0: float = 1.0      # initial penalty sigma_i^0
    kappa_lo: int = 3        # communication period interval [lo, hi]
    kappa_hi: int = 7
    mask_mode: str = "exact"  # "exact" (paper) | "bernoulli" (huge leaves)
    homogeneous_kappa: Optional[int] = None  # set to force kappa_i = k0
    exchange: str = "dense"  # "dense" | "compressed" | "compressed_q8"
    mixing: str = "dense"    # "dense" ([m, m] selection) | "sparse" (padded)
    partition: str = "flat"  # "flat" (one vector) | "tree" (leaf segments)
    p_leaf: Optional[Tuple[float, ...]] = None  # per-leaf rates, tree only

    def __post_init__(self):
        if self.partition not in ("flat", "tree"):
            raise ValueError(
                f"unknown partition {self.partition!r}; pick 'flat' or 'tree'"
            )
        if self.p_leaf is not None:
            if self.partition != "tree":
                raise ValueError("p_leaf requires partition='tree'")
            object.__setattr__(
                self, "p_leaf", tuple(float(r) for r in self.p_leaf)
            )
        if self.partition == "tree" and self.exchange != "dense":
            raise NotImplementedError(
                "partition='tree' needs exchange='dense'; the compressed "
                "wire formats still assume a single flat payload"
            )


class TopologyArrays(NamedTuple):
    """Device-side view of a Topology."""

    nbrs: torch.Tensor   # [m, d] padded neighbour ids (int64)
    valid: torch.Tensor  # [m, d] bool
    t: torch.Tensor      # [m] t_i = max(1, floor(nu_i |N_i|)) (int32)
    kappa: torch.Tensor  # [m] per-node communication periods (int32)


class LaneTopologyArrays(NamedTuple):
    """L lanes' topology arrays: each lane's own (its config's t_i and
    kappa_i) and the folded [L·m, d] tables the exchange gathers over,
    every slot of lane l offset by l·m (`fold_topology_arrays`)."""

    lanes: tuple         # L TopologyArrays of m nodes each
    nbrs: torch.Tensor   # [L·m, d] lane-offset neighbour ids (padding too)
    valid: torch.Tensor  # [L·m, d] bool
    t: torch.Tensor      # [L·m] int32


class PaMEState(NamedTuple):
    params: object        # pytree, leaves [m, ...] ([L, m, ...] lane-batched)
    sigma: torch.Tensor   # [m] float32
    step: int             # host-side step counter (int64 [L] lane-batched)
    key: int              # seed of the run's randomness (int64 [L] lane-batched)


def make_topology_arrays(
    topo: Topology, cfg: PaMEConfig, seed: int = 0, device=None
) -> TopologyArrays:
    nbrs, valid = topo.neighbor_matrix_padded()
    t = np.maximum(1, np.floor(cfg.nu * topo.degrees)).astype(np.int32)
    rng = np.random.default_rng(seed)
    if cfg.homogeneous_kappa is not None:
        kappa = np.full(topo.m, cfg.homogeneous_kappa, dtype=np.int32)
    else:
        kappa = rng.integers(cfg.kappa_lo, cfg.kappa_hi + 1, topo.m).astype(np.int32)
    return TopologyArrays(
        nbrs=torch.as_tensor(nbrs, dtype=torch.int64, device=device),
        valid=torch.as_tensor(valid, device=device),
        t=torch.as_tensor(t, device=device),
        kappa=torch.as_tensor(kappa, device=device),
    )


def fold_topology_arrays(lanes) -> LaneTopologyArrays:
    """The lane-offset tables of L lanes' `TopologyArrays` (one graph),
    built once at bind time."""
    return LaneTopologyArrays(
        lanes=tuple(lanes),
        nbrs=LN.offset_rows([ta.nbrs for ta in lanes]),
        valid=torch.cat([ta.valid for ta in lanes]),
        t=torch.cat([ta.t for ta in lanes]),
    )


def pame_init(key, params_stacked, m: int, cfg: PaMEConfig) -> PaMEState:
    """W^0 = 0 per Setup 1 is the caller's choice; any stacked init works
    as long as it lies in N(delta) (Lemma 3).  A per-lane key (an int
    array [L]) starts L lanes folded into the leaves' rows, each lane's
    sigma at its own sigma0 (a per-lane tuple)."""
    del m
    leaf = tree_leaves(params_stacked)[0]
    if LN.count(key) is None:
        return PaMEState(
            params=params_stacked,
            sigma=torch.full((leaf.shape[0],), cfg.sigma0, dtype=torch.float32,
                             device=leaf.device),
            step=0,
            key=int(key),
        )
    key = np.asarray(key, dtype=np.int64)
    sl = LN.lane_slices(leaf.shape[0], key)
    return PaMEState(
        params=params_stacked,
        sigma=torch.cat([torch.full((s.stop - s.start,), LN.lane_value(cfg.sigma0, lane),
                                    dtype=torch.float32, device=leaf.device)
                         for lane, s in enumerate(sl)]),
        step=np.zeros_like(key),
        key=key,
    )


def _not_ported(what: str):
    raise NotImplementedError(f"{what} not yet ported to repro_torch")


def pame_step(
    state: PaMEState,
    batch,  # pytree, leaves [m, ...] (per-node sub-batches B_i^k)
    grad_fn: GradFn,
    topo,   # TopologyArrays, or LaneTopologyArrays for a lane-batched state
    cfg: PaMEConfig,
    param_shardings=None,
    realization=None,
    self_params=None,
    delivered=None,
    *,
    draws: Optional[dict] = None,  # {"sel" | "a": selection, "masks" | "offsets": [...]}
) -> Tuple[PaMEState, dict]:
    """One step of Algorithm 1.  `draws` replaces the step's own sampling:
    ``sel`` ([m, d] bool, dense exchange with mixing="sparse") or ``a``
    ([m, m]), and ``masks`` (dense exchange) or ``offsets`` (compressed
    exchange, `repro_torch.core.gossip`), one per leaf in JAX leaf order.
    The compressed exchanges use the [m, m] selection whatever `mixing`
    says, as in JAX.

    Dynamic networks, as in JAX: `realization` (`core.scenarios`) keeps
    offline and straggling receivers out of the exchange and restricts
    selection to the realized edges, and the step reports its realized
    Eq.-(8) ``wire_bits``; `self_params` is each node's fresh view for the
    λ = 0 fill while `state.params` carries the delayed stack the wire
    transports (it keeps the dense exact exchange on the plain average, as
    JAX's kernel route takes its fill from W); `delivered` ([m, d] bool,
    padded selection only) lets only delivered messages into the average
    while every selected one is charged.  An injected ``sel`` / ``a`` must
    already be the realized selection.

    Lanes: with `LaneTopologyArrays` the state holds L lanes folded into
    its [L·m, ...] rows (key and step int64 [L], per-lane tuples for the
    swept floats of `cfg`); draws are then folded too (``sel``, ``masks``
    and ``offsets`` concatenated over the lanes' rows, ``a`` [L, m, m]),
    and the metrics come back [L].  A dynamic network's `realization`,
    `self_params` and `delivered` are folded over the same L·m rows."""
    if param_shardings is not None:
        _not_ported("param_shardings")
    if cfg.exchange not in ("dense", "compressed", "compressed_q8"):
        raise ValueError(f"unknown exchange {cfg.exchange!r}")
    batched = isinstance(topo, LaneTopologyArrays)
    lane_arrays = topo.lanes if batched else (topo,)
    n_lanes = len(lane_arrays)
    m = lane_arrays[0].nbrs.shape[0]
    device = topo.nbrs.device
    steps = [int(st) for st in np.atleast_1d(state.step)]
    # selection, mask and data keys (one a lane for a lane-batched state)
    k_sel, k_mask, k_data = (LN.fold(state.key, state.step * 3 + i) for i in range(3))
    draws = draws or {}
    masks = draws.get("masks")

    if cfg.partition == "tree":
        rate = pme.leaf_rates(len(tree_leaves(state.params)), cfg.p, cfg.p_leaf)
    else:
        rate = cfg.p

    comm = [(st % ta.kappa) == 0 for st, ta in zip(steps, lane_arrays)]  # k in K_i
    rows = LN.lane_slices(n_lanes * m, state.key)
    survivors = [None] * n_lanes
    if realization is not None:
        # offline / straggling receivers skip the exchange; senders are
        # filtered through the realized edge set (each lane its own rows)
        part, alive_edges = (realization.participating.to(device),
                             realization.edge_alive.to(device))
        comm = [c & part[sl] for c, sl in zip(comm, rows)]
        survivors = [alive_edges[sl] for sl in rows]

    def lanewise(sample):
        """Each lane's selection from its own key, on its own m-node arrays."""
        return [sample(pme.make_generator(k, device), ta.nbrs, ta.valid, ta.t, c,
                       survivors=sv)
                for k, ta, c, sv in zip(LN.keys(k_sel), lane_arrays, comm, survivors)]

    if cfg.exchange == "dense" and cfg.mixing == "sparse":
        # padded neighbour exchange: the [m, m] selection matrix is never built
        sel = draws.get("sel")
        if sel is None:
            sel = torch.cat(lanewise(pme.sample_neighbor_selection_padded))
        sel = sel.to(device)
        n_messages = sel.reshape(n_lanes, -1).sum(dim=1)
        if delivered is not None:
            sel = sel & delivered.to(device)
        v_bar = pme.pme_average_pytree_padded(
            k_mask, state.params, topo.nbrs, sel, rate,
            mode=cfg.mask_mode, pad=~topo.valid, self_params=self_params, masks=masks,
        )
    else:
        if delivered is not None:
            raise NotImplementedError(
                "message-level delivery masks need mixing='sparse' (padded "
                "selection); the dense selection matrix has no per-slot "
                "delivery channel"
            )
        a = draws.get("a")
        if a is None:
            a = torch.stack(lanewise(pme.sample_neighbor_selection))
            a = a if batched else a[0]
        a = a.to(device)
        n_messages = a.reshape(n_lanes, -1).sum(dim=1)
        if cfg.exchange == "dense":
            v_bar = pme.pme_average_pytree(
                k_mask, state.params, a, rate, mode=cfg.mask_mode,
                self_params=self_params, masks=masks,
            )
        else:
            if self_params is not None:
                raise NotImplementedError(
                    "self_params (message-only delay) is not supported on the "
                    "compressed exchange path"
                )
            v_bar = _compressed_exchange(k_mask, state.params, a if batched else a[None],
                                         cfg, draws.get("offsets"))

    # Per-node gradients at v_bar, one node at a time (not a vmap): at full
    # width this keeps a single node's activations alive.  v_bar is a fresh
    # tensor from the exchange, so node i's local step updates its rows in
    # place once node i's gradient is taken — the other nodes' gradients
    # read only their own rows.  Row r is node r % m of lane r // m.
    stepsize = 1.0 / (state.sigma * topo.t.float())
    leaves, treedef = tree_flatten(v_bar)
    batch_leaves, batch_def = tree_flatten(batch)
    losses = []
    for r in range(n_lanes * m):
        lane, i = divmod(r, m)
        p_i = tree_unflatten(treedef, [x[r].detach().requires_grad_(True) for x in leaves])
        b_i = tree_unflatten(batch_def, [b[i] for b in batch_leaves])
        loss_i, g_i = grad_fn(p_i, b_i, pme.fold_in(LN.lane_key(k_data, lane), i))
        losses.append(loss_i.detach().float().reshape(()))
        with torch.no_grad():
            for x, g in zip(leaves, tree_leaves(g_i)):
                # w_i = v_i - g_i * (1 / (sigma_i t_i)), the step cast to
                # the leaf's type before the multiply
                x[r].sub_(g.to(x.dtype) * stepsize[r].to(x.dtype))
        del p_i, g_i
    new_params = v_bar

    # per lane: consensus error ||W - Pi||_F^2 (metric of Lemma 6) and the
    # penalty's growth sigma <- gamma * sigma
    consensus = [sum(torch.sum((x[sl] - x[sl].mean(dim=0, keepdim=True)) ** 2).float()
                     for x in leaves) for sl in rows]
    sigma = [state.sigma[sl] * LN.lane_value(cfg.gamma, lane) for lane, sl in enumerate(rows)]
    new_state = PaMEState(
        params=new_params,
        sigma=torch.cat(sigma) if batched else sigma[0],
        step=state.step + 1,
        key=state.key,
    )
    metrics = {
        "loss_mean": LN.lane_mean(losses, state.key),
        "consensus": consensus,
        "comm_nodes": [c.sum() for c in comm],
        "sigma_mean": [sg.mean() for sg in sigma],
    }
    for name in ("consensus", "comm_nodes", "sigma_mean"):
        metrics[name] = torch.stack(metrics[name]) if batched else metrics[name][0]
    if realization is not None:
        # realized Eq.-(8) accounting: each selected surviving neighbour
        # sends one sparse message (int8 values under compressed_q8); flat
        # partition prices one vector of s = round(p·n) coordinates, tree
        # partition the per-leaf segments
        sizes = [int(np.prod(tuple(x.shape[1:]))) for x in leaves]
        value_bits = 8 if cfg.exchange == "compressed_q8" else 64
        if cfg.partition == "tree":
            bits = pme.tree_message_bits(sizes, rate, value_bits)
        else:
            n_total = sum(sizes)
            bits = pme.message_bits(max(1, int(round(cfg.p * n_total))), n_total, value_bits)
        wire = n_messages.to(torch.float32) * float(bits)
        metrics["wire_bits"] = wire if batched else wire[0]
    return new_state, metrics


def _compressed_exchange(k_mask, params, a, cfg: PaMEConfig, offsets):
    """The compressed exchange lane by lane (it runs no kernel): lane l's
    rows with its [m, m] selection a[l], its key and its offsets."""
    leaves, treedef = tree_flatten(params)
    outs = []
    for lane, (key, sl) in enumerate(zip(LN.keys(k_mask),
                                         LN.lane_slices(leaves[0].shape[0], k_mask))):
        part = tree_unflatten(treedef, [x[sl] for x in leaves])
        offs = None if offsets is None else [o[sl] for o in offsets]
        outs.append(tree_leaves(gossip.compressed_pme_average_pytree(
            key, part, a[lane], cfg.p,
            quantize_bits=8 if cfg.exchange == "compressed_q8" else 0, offsets=offs)))
    if len(outs) == 1:
        return tree_unflatten(treedef, outs[0])
    return tree_unflatten(treedef, [torch.cat(xs) for xs in zip(*outs)])


def _stack_params(params0, m: int):
    return tree_map(
        lambda x: x.unsqueeze(0).expand((m,) + tuple(x.shape)).contiguous(), params0
    )


def _on(device, tree):
    return tree_map(
        lambda x: x.to(device) if isinstance(x, torch.Tensor) else x, tree
    )


def make_pame_runner(
    grad_fn: GradFn,
    topo: Topology,
    cfg: PaMEConfig,
    *,
    objective_fn: Optional[Callable] = None,
    tol_std: float = 1e-3,
    chunk_size: int = engine.DEFAULT_CHUNK_SIZE,
    seed: int = 0,
    param_shardings=None,
    device=None,
    draws_fn: Optional[Callable[[int], dict]] = None,
) -> Callable:
    """Build a reusable chunked PaME driver on `device` (default ``cuda``).

    Returns ``run(key, params0, m, batch_fn, num_steps) -> (state,
    history)``.  ``draws_fn(step)``, when given, supplies each step's draws
    (see `pame_step`) instead of the step's own sampling.
    """
    if param_shardings is not None:
        _not_ported("param_shardings")
    dev = resolve_device(device)
    topo_arrays = make_topology_arrays(topo, cfg, seed=seed, device=dev)

    def step_fn(state, batch):
        draws = draws_fn(state.step) if draws_fn is not None else None
        return pame_step(state, _on(dev, batch), grad_fn, topo_arrays, cfg,
                         draws=draws)

    runner = engine.make_scan_runner(
        step_fn, objective_fn=objective_fn, tol_std=tol_std, chunk_size=chunk_size,
    )

    def run(key, params0, m, batch_fn, num_steps):
        # the state is built here, so the runner owns it outright
        state, metrics, info = runner(
            engine.Donated(pame_init(key, _stack_params(_on(dev, params0), m), m, cfg)),
            batch_fn, num_steps)
        history = engine.history_from(metrics, info, {
            "loss": "loss_mean",
            "objective": "objective",
            "consensus": "consensus",
        })
        return state, history

    return run


def run_pame(
    key: int,
    params0,  # single-node pytree; stacked m times
    m: int,
    grad_fn: GradFn,
    batch_fn: Callable[[int], object],  # step -> per-node batch pytree [m, ...]
    topo: Topology,
    cfg: PaMEConfig,
    num_steps: int = 200,
    objective_fn: Optional[Callable] = None,
    tol_std: float = 1e-3,
    seed: int = 0,
    driver: str = "scan",
    chunk_size: int = engine.DEFAULT_CHUNK_SIZE,
    *,
    device=None,
    draws_fn: Optional[Callable[[int], dict]] = None,
) -> Tuple[PaMEState, dict]:
    """Run PaME with the paper's termination rule: stop when
    std{f(w^{k-2}), f(w^{k-1}), f(w^k)} < tol_std.

    driver="scan" (default) runs `chunk_size` steps per host sync through
    `repro_torch.core.engine`; driver="host" is the one-step-at-a-time
    reference loop, kept for equivalence testing.  Runs on ``cuda`` unless
    `device` says otherwise.
    """
    if driver == "scan":
        run = make_pame_runner(
            grad_fn, topo, cfg, objective_fn=objective_fn, tol_std=tol_std,
            chunk_size=chunk_size, seed=seed, device=device, draws_fn=draws_fn,
        )
        return run(key, params0, m, batch_fn, num_steps)
    if driver != "host":
        raise ValueError(f"unknown driver {driver!r}")

    dev = resolve_device(device)
    topo_arrays = make_topology_arrays(topo, cfg, seed=seed, device=dev)
    state = pame_init(key, _stack_params(_on(dev, params0), m), m, cfg)
    history = {"loss": [], "objective": [], "consensus": []}
    f_window: list = []
    for k in range(num_steps):
        draws = draws_fn(state.step) if draws_fn is not None else None
        state, metrics = pame_step(state, _on(dev, batch_fn(k)), grad_fn,
                                   topo_arrays, cfg, draws=draws)
        history["loss"].append(float(metrics["loss_mean"]))
        history["consensus"].append(float(metrics["consensus"]))
        if objective_fn is not None:
            mean_params = tree_map(lambda x: x.mean(dim=0), state.params)
            fval = float(objective_fn(mean_params))
            history["objective"].append(fval)
            f_window.append(fval)
            if len(f_window) >= 3 and float(np.std(f_window[-3:])) < tol_std:
                break
    history["steps_run"] = len(history["loss"])
    history["steps_dispatched"] = history["steps_run"]
    return state, history
