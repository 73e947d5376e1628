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

Sharded (``param_shardings=``, a `repro_torch.sharding.MeshShardings` of
`sharding.state_shardings(...).params` over a (node, fsdp, model) mesh,
`launch.mesh.make_logical_mesh`): the state holds this rank's pieces —
its nodes' rows ([m / node, ...] leaves and sigma) and its fsdp / model
piece of every leaf — and the batch its nodes' whole sub-batches.  Every
rank draws the step's selection, masks and offsets for all m nodes at the
whole leaves' shapes (or takes the same injected draws) and keeps its
part; the exchange gathers over ``node`` only (`core.pme`,
`core.gossip`).  Each local node's loss and gradient then run one of two
ways:

  * a ``grad_fn`` that takes a ``view`` keyword (``grad_fn(p, b, key, *,
    view)``, as `launch.train.lm_grad_fn`'s does) gets this rank's pieces
    of node i, the node's `sharding.train_view` and this rank's rows of
    node i's batch, and returns the node's loss and the gradient of those
    pieces: the forward runs tensor-parallel over `model`, each layer
    gathered over fsdp just before it runs, its backward reduce-scattered
    (as JAX's XLA partitions ``vmap(grad_fn)`` on ``v_bar`` pinned to the
    parameters' placements).  No rank holds a node's whole leaves or
    gradient.  The batch then holds this rank's piece under
    `sharding.batch_shardings(..., node_stacked=True)`: its nodes, and the
    rows of each over fsdp (`shard_batch`);
  * any other ``grad_fn`` gets each local node's leaves gathered whole over
    fsdp and model and its nodes' whole sub-batches, runs as the unsharded
    step runs (gather before compute, as ZeRO-3 does), and the rank keeps
    its piece of the update.

Unsharded, both take the same body on the unsharded view.  ``loss_mean``
is the mean of the gathered per-node losses and
``consensus`` and ``sigma_mean`` are reduced over the ranks, so every
rank reports the global values (and the engine's stop rule stops every
rank at the same step).  The dense and sparse exchanges give the
unsharded step's state bit for bit; the compressed ones follow JAX's
sharded exchange.  A dynamic network's inputs are taken as unsharded:
the realization and ``delivered`` whole (every rank draws the same
realized selection for all m nodes), ``self_params`` as this rank's
pieces of the fresh stack, and the realized ``wire_bits`` are priced at
the whole leaves' sizes, so they equal the unsharded step's.  Lanes are
not taken with shardings: JAX shards none (its `bind_batched` vmaps the
unsharded step).
"""
from __future__ import annotations

import dataclasses
import inspect
import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch import sharding as shd
from repro_torch.core import engine, gossip, pme
from repro_torch.core import lanes as LN
from repro_torch.core.topology import Topology
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

__all__ = [
    "PaMEConfig", "PaMEState", "TopologyArrays", "LaneTopologyArrays",
    "make_topology_arrays", "fold_topology_arrays",
    "pame_init", "pame_step", "make_pame_runner", "run_pame", "takes_view", "shard_batch",
]

# grad_fn(params_i, batch_i, key_i) -> (loss_i, grads_i); key_i is an int seed
# for node i's own randomness (the LM and regression losses ignore it).  A
# grad_fn may also take a keyword `view` (`sharding.train_view`): it then
# takes this rank's pieces of node i and its rows of node i's batch
GradFn = Callable[[object, object, int], Tuple[torch.Tensor, object]]


def takes_view(grad_fn: GradFn) -> bool:
    """Whether `grad_fn` takes a ``view`` keyword (the tensor-parallel route
    of the sharded step)."""
    return "view" in inspect.signature(grad_fn).parameters


def shard_batch(batch, param_shardings, grad_fn: GradFn):
    """This rank's piece of a whole [m, ...] batch as `pame_step` takes it
    with `param_shardings`: its nodes' rows, and for a `grad_fn` that takes
    a view each node's rows split over fsdp as
    `sharding.batch_shardings(..., node_stacked=True)` places them (which
    must split them: a node's rows divide over fsdp)."""
    if param_shardings is None:
        return batch
    layout = shd.mesh_layout(param_shardings.mesh)
    coord = shd.mesh_coords(param_shardings.mesh)
    if not takes_view(grad_fn):
        return tree_map(lambda b: shd.cut(b, ("node",), layout, coord), batch)
    place = shd.batch_shardings(batch, layout, node_stacked=True)
    for leaf, spec in zip(tree_leaves(batch), shd.leaf_specs(batch, place)):
        if layout["fsdp"] > 1 and (len(spec) < 2 or spec[1] != "fsdp"):
            raise ValueError(f"a node's {leaf.shape[1]} rows do not divide over "
                             f"{layout['fsdp']} fsdp ranks")
    return shd.shard_tree(batch, place, layout, coord)


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
    `self_params` and `delivered` are folded over the same L·m rows.

    Sharded (`param_shardings`): `realization` and `delivered` are whole
    ([m, ...], the same on every rank) and `self_params` this rank's pieces
    of the fresh stack, as `state.params` holds its pieces of the delayed
    one; lanes raise."""
    if cfg.exchange not in ("dense", "compressed", "compressed_q8"):
        raise ValueError(f"unknown exchange {cfg.exchange!r}")
    batched = isinstance(topo, LaneTopologyArrays)
    sharded = param_shardings is not None
    if sharded and batched:
        raise NotImplementedError("param_shardings with lanes (LaneTopologyArrays): JAX "
                                  "shards no lanes either (its bind_batched vmaps the "
                                  "unsharded step)")
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
            shardings=param_shardings,
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
                self_params=self_params, masks=masks, shardings=param_shardings,
            )
        else:
            if self_params is not None:
                raise NotImplementedError(
                    "self_params (message-only delay) is not supported on the "
                    "compressed exchange path"
                )
            v_bar = _compressed_exchange(k_mask, state.params, a if batched else a[None],
                                         cfg, draws.get("offsets"), param_shardings)

    # Per-node gradients at v_bar, one node at a time (not a vmap): at full
    # width this keeps a single node's activations alive.  v_bar is a fresh
    # tensor from the exchange, so node i's local step updates its rows in
    # place once node i's gradient is taken — the other nodes' gradients
    # read only their own rows.  Row r0 + r is node (r0 + r) % m of lane
    # (r0 + r) // m.  Sharded, a grad_fn that takes a view runs on this
    # rank's pieces and rows (tensor-parallel); any other gets a node's
    # leaves gathered whole over fsdp and model and the rank keeps its
    # piece of the update (unsharded, the view's collectives are the
    # identity and its cuts the whole tensor).
    loc = shd.local_view(param_shardings, v_bar)
    stepsize = 1.0 / (state.sigma * topo.t[loc.rows()].float())
    leaves, treedef = tree_flatten(v_bar)
    batch_leaves, batch_def = tree_flatten(batch)
    view = shd.train_view(loc, treedef) if takes_view(grad_fn) else None
    losses = []
    for r in range(loc.r):
        lane, i = divmod(loc.r0 + r, m)
        if view is None:
            mine = [shd.gather_dims(x[r:r + 1], spec, loc.mesh, ("fsdp", "model"),
                                    use="gradient")[0] for x, spec in zip(leaves, loc.specs)]
        else:
            mine = [x[r] for x in leaves]
        p_i = tree_unflatten(treedef, [w.detach().requires_grad_(True) for w in mine])
        b_i = tree_unflatten(batch_def, [b[i - loc.r0] for b in batch_leaves])
        key_i = pme.fold_in(LN.lane_key(k_data, lane), i)
        loss_i, g_i = (grad_fn(p_i, b_i, key_i) if view is None
                       else grad_fn(p_i, b_i, key_i, view=view))
        losses.append(loss_i.detach().float().reshape(()))
        del p_i, mine
        with torch.no_grad():
            for x, g, spec in zip(leaves, tree_leaves(g_i), loc.specs):
                # w_i = v_i - g_i * (1 / (sigma_i t_i)), the step cast to
                # the leaf's type before the multiply (this rank's piece)
                if view is None:
                    g = shd.cut(g, spec[1:], loc.layout, loc.coord)
                x[r].sub_(g.to(x.dtype) * stepsize[r].to(x.dtype))
        del g_i
    new_params = v_bar

    # per lane, over every rank's rows: the losses' mean, the consensus
    # error ||W - Pi||_F^2 (metric of Lemma 6; each piece counted once, the
    # node mean from an f32 sum in the leaf's type) and the penalty's
    # growth sigma <- gamma * sigma
    mesh = loc.mesh
    losses = shd.all_gather(torch.stack(losses), mesh, "node", use="metrics")
    lane_rows = LN.lane_slices(loc.r, state.key)
    consensus = []
    for sl in lane_rows:
        c = torch.zeros((), dtype=torch.float32, device=device)
        for x, spec in zip(leaves, loc.specs):
            mean = shd.all_reduce(x[sl].sum(dim=0, keepdim=True, dtype=torch.float32), mesh,
                                  ("node",), use="metrics").div_(m)
            if shd.owns(spec, loc.coord):
                c += torch.sum((x[sl] - mean.to(x.dtype)) ** 2).float()
            del mean
        consensus.append(shd.all_reduce(c, mesh, shd.AXES, use="metrics"))
    sigma = [state.sigma[sl] * LN.lane_value(cfg.gamma, lane)
             for lane, sl in enumerate(lane_rows)]
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
        "sigma_mean": [shd.all_gather(sg, mesh, "node", use="metrics").mean() for sg in sigma],
    }
    for name in ("consensus", "comm_nodes", "sigma_mean"):
        metrics[name] = torch.stack(metrics[name]) if batched else metrics[name][0]
    if realization is not None:
        # realized Eq.-(8) accounting: each selected surviving neighbour
        # sends one sparse message (int8 values under compressed_q8); flat
        # partition prices one vector of s = round(p·n) coordinates, tree
        # partition the per-leaf segments; each leaf's whole size (this
        # rank's pieces are a share of it)
        sizes = [math.prod(shd.full_shape(x.shape, spec, loc.layout)[1:])
                 for x, spec in zip(leaves, loc.specs)]
        value_bits = 8 if cfg.exchange == "compressed_q8" else 64
        if cfg.partition == "tree":
            bits = pme.tree_message_bits(sizes, rate, value_bits)
        else:
            n_total = sum(sizes)
            bits = pme.message_bits(max(1, int(round(cfg.p * n_total))), n_total, value_bits)
        wire = n_messages.to(torch.float32) * float(bits)
        metrics["wire_bits"] = wire if batched else wire[0]
    return new_state, metrics


def _compressed_exchange(k_mask, params, a, cfg: PaMEConfig, offsets, shardings=None):
    """The compressed exchange lane by lane (it runs no kernel): lane l's
    rows with its [m, m] selection a[l], its key and its offsets; with
    `shardings`, this rank's pieces of its one lane (the offsets all m
    nodes')."""
    leaves, treedef = tree_flatten(params)
    lanes = LN.lane_slices(leaves[0].shape[0], k_mask)
    outs = []
    for lane, (key, sl) in enumerate(zip(LN.keys(k_mask), lanes)):
        part, offs = params, offsets
        if len(lanes) > 1:
            part = tree_unflatten(treedef, [x[sl] for x in leaves])
            offs = None if offsets is None else [o[sl] for o in offsets]
        outs.append(tree_leaves(gossip.compressed_pme_average_pytree(
            key, part, a[lane], cfg.p,
            quantize_bits=8 if cfg.exchange == "compressed_q8" else 0, offsets=offs,
            shardings=shardings)))
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
    (see `pame_step`) instead of the step's own sampling.  With
    `param_shardings` (a `repro_torch.sharding.MeshShardings`) every rank
    calls ``run`` with the same whole ``params0`` and ``batch_fn`` (whole
    [m, ...] batches): it keeps its pieces of the stacked parameters and
    its piece of each batch (`shard_batch`), steps the sharded `pame_step`,
    and gets back its pieces of the state and the global history; the stop rule's
    objective is taken on the node-mean parameters gathered whole, the
    same on every rank.
    """
    dev = resolve_device(device)
    topo_arrays = make_topology_arrays(topo, cfg, seed=seed, device=dev)
    sh = param_shardings

    def step_fn(state, batch):
        draws = draws_fn(state.step) if draws_fn is not None else None
        return pame_step(state, shard_batch(_on(dev, batch), sh, grad_fn), grad_fn,
                         topo_arrays, cfg, param_shardings=sh, draws=draws)

    def node_mean(params):
        # every node's piece gathered over "node", averaged, then made whole
        mean = tree_map(lambda x: shd.all_gather(x, sh.mesh, "node", use="objective")
                        .mean(dim=0, keepdim=True), params)
        return tree_map(lambda x: x[0], shd.gather_tree(mean, sh, ("fsdp", "model"),
                                                        use="objective"))

    runner = engine.make_scan_runner(
        step_fn, objective_fn=objective_fn, tol_std=tol_std, chunk_size=chunk_size,
        node_mean=None if sh is None else node_mean,
    )

    def stacked(params0, m):
        if sh is None:
            return _stack_params(_on(dev, params0), m)
        # this rank's piece of each leaf, stacked for its own nodes only
        layout, coord = shd.mesh_layout(sh.mesh), shd.mesh_coords(sh.mesh)
        leaves, treedef = tree_flatten(_on(dev, params0))
        r = m // layout["node"]
        out = []
        for x, spec in zip(leaves, shd.leaf_specs(params0, sh.specs)):
            piece = shd.cut(x, spec[1:], layout, coord)
            out.append(piece.unsqueeze(0).expand((r,) + tuple(piece.shape)).contiguous())
        return tree_unflatten(treedef, out)

    def run(key, params0, m, batch_fn, num_steps):
        # the state is built here, so the runner owns it outright
        state, metrics, info = runner(
            engine.Donated(pame_init(key, stacked(params0, m), m, cfg)),
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
