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
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import engine, pme
from repro_torch.core.topology import Topology
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

__all__ = [
    "PaMEConfig", "PaMEState", "TopologyArrays", "make_topology_arrays",
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


class PaMEState(NamedTuple):
    params: object        # pytree, leaves [m, ...]
    sigma: torch.Tensor   # [m] float32
    step: int             # host-side step counter
    key: int              # seed of the run's randomness


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


def pame_init(key: int, params_stacked, m: int, cfg: PaMEConfig) -> PaMEState:
    """W^0 = 0 per Setup 1 is the caller's choice; any stacked init works
    as long as it lies in N(delta) (Lemma 3)."""
    del m
    leaf = tree_leaves(params_stacked)[0]
    return PaMEState(
        params=params_stacked,
        sigma=torch.full((leaf.shape[0],), cfg.sigma0, dtype=torch.float32,
                         device=leaf.device),
        step=0,
        key=int(key),
    )


def _not_ported(what: str):
    raise NotImplementedError(f"{what} not yet ported to repro_torch")


def pame_step(
    state: PaMEState,
    batch,  # pytree, leaves [m, ...] (per-node sub-batches B_i^k)
    grad_fn: GradFn,
    topo: TopologyArrays,
    cfg: PaMEConfig,
    param_shardings=None,
    realization=None,
    self_params=None,
    delivered=None,
    *,
    draws: Optional[dict] = None,  # {"sel" | "a": selection, "masks": [...]}
) -> Tuple[PaMEState, dict]:
    """One step of Algorithm 1.  `draws` replaces the step's own sampling:
    ``sel`` ([m, d] bool, mixing="sparse") or ``a`` ([m, m], dense), and
    ``masks``, one per leaf in JAX leaf order."""
    if param_shardings is not None:
        _not_ported("param_shardings")
    if realization is not None:
        _not_ported("dynamic-network realization")
    if self_params is not None:
        _not_ported("self_params (message-only delay)")
    if delivered is not None:
        _not_ported("delivered (message-level faults)")
    if cfg.exchange != "dense":
        _not_ported(f"exchange={cfg.exchange!r}")
    m = topo.nbrs.shape[0]
    device = topo.nbrs.device
    k_sel, k_mask, k_data = (
        pme.fold_in(state.key, state.step * 3 + i) for i in range(3)
    )
    draws = draws or {}
    masks = draws.get("masks")

    if cfg.partition == "tree":
        rate = pme.leaf_rates(len(tree_leaves(state.params)), cfg.p, cfg.p_leaf)
    else:
        rate = cfg.p

    comm_mask = (state.step % topo.kappa) == 0  # k in K_i
    if cfg.mixing == "sparse":
        # padded neighbour exchange: the [m, m] selection matrix is never built
        sel = draws.get("sel")
        if sel is None:
            sel = pme.sample_neighbor_selection_padded(
                pme.make_generator(k_sel, device), topo.nbrs, topo.valid,
                topo.t, comm_mask,
            )
        v_bar = pme.pme_average_pytree_padded(
            k_mask, state.params, topo.nbrs, sel.to(device), rate,
            mode=cfg.mask_mode, pad=~topo.valid, masks=masks,
        )
    else:
        a = draws.get("a")
        if a is None:
            a = pme.sample_neighbor_selection(
                pme.make_generator(k_sel, device), topo.nbrs, topo.valid,
                topo.t, comm_mask,
            )
        v_bar = pme.pme_average_pytree(
            k_mask, state.params, a.to(device), rate, mode=cfg.mask_mode,
            masks=masks,
        )

    # Per-node gradients at v_bar, one node at a time (not a vmap): at full
    # width this keeps a single node's activations alive.  v_bar is a fresh
    # tensor from the exchange, so node i's local step updates its rows in
    # place once node i's gradient is taken — the other nodes' gradients
    # read only their own rows.
    stepsize = 1.0 / (state.sigma * topo.t.float())
    leaves, treedef = tree_flatten(v_bar)
    batch_leaves, batch_def = tree_flatten(batch)
    losses = []
    for i in range(m):
        p_i = tree_unflatten(treedef, [x[i].detach().requires_grad_(True) for x in leaves])
        b_i = tree_unflatten(batch_def, [b[i] for b in batch_leaves])
        loss_i, g_i = grad_fn(p_i, b_i, pme.fold_in(k_data, i))
        losses.append(loss_i.detach().float().reshape(()))
        with torch.no_grad():
            for x, g in zip(leaves, tree_leaves(g_i)):
                # w_i = v_i - g_i * (1 / (sigma_i t_i)), the step cast to
                # the leaf's type before the multiply
                x[i].sub_(g.to(x.dtype) * stepsize[i].to(x.dtype))
        del p_i, g_i
    new_params = v_bar

    # consensus error ||W - Pi||_F^2 (metric of Lemma 6)
    consensus = sum(
        torch.sum((x - x.mean(dim=0, keepdim=True)) ** 2).float() for x in leaves
    )
    new_state = PaMEState(
        params=new_params,
        sigma=state.sigma * cfg.gamma,
        step=state.step + 1,
        key=state.key,
    )
    metrics = {
        "loss_mean": torch.stack(losses).mean(),
        "consensus": consensus,
        "comm_nodes": comm_mask.sum(),
        "sigma_mean": new_state.sigma.mean(),
    }
    return new_state, metrics


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
        state = pame_init(key, _stack_params(_on(dev, params0), m), m, cfg)
        # the state was built here, so the runner may own it outright
        state, metrics, info = runner(state, batch_fn, num_steps, copy_state=False)
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
