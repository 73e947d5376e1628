"""Algorithm registry for decentralized FL (port of `repro.core.algorithms`).

One contract for every registered algorithm:

  * :class:`Algorithm` — a named spec with a hyperparameter dataclass,
    ``init``/``step`` glue, per-step expected wire bits (Eq. (8)) and
    ``params_of`` for reading the node-stacked parameters out of a state;
  * :func:`register` / :func:`get_algorithm` / :func:`list_algorithms`;
  * :meth:`Algorithm.bind` — closes a spec over (grad_fn, topology, hps,
    mixing mode, device) and returns a :class:`BoundAlgorithm` whose
    ``step`` the engine runs.

This slice registers PaME only; the five baselines, their mixers, dynamic
scenarios, faults, serving pacing and batched lanes come in later slices
and raise until then.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import engine
from repro_torch.core import pame as pame_mod
from repro_torch.core.pme import leaf_rates as pme_leaf_rates
from repro_torch.core.pme import message_bits, tree_message_bits
from repro_torch.core.topology import Topology
from repro_torch.tree import tree_leaves, tree_map

__all__ = [
    "Algorithm", "BoundAlgorithm", "AlgoContext",
    "register", "get_algorithm", "list_algorithms", "PaMEHp",
]

PaMEHp = pame_mod.PaMEConfig


@dataclasses.dataclass(frozen=True)
class AlgoContext:
    """Everything a registered step needs beyond (state, batch).  `mixer`
    stays None until the baselines' `Mixer` is ported."""

    grad_fn: Callable
    topo: Topology
    hps: object
    mixer: object
    extras: dict


@dataclasses.dataclass(frozen=True)
class Algorithm:
    """A registered DFL algorithm: ``init(key, params_stacked, ctx, batch0)``,
    ``step(state, batch, ctx) -> (state, metrics)`` with a ``loss_mean``
    metric, ``wire_bits(topo, hps, n)`` expected bits per step.  The JAX
    registry's fields for scenarios, faults and batched sweeps arrive with
    the code that reads them."""

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

    def bind(
        self,
        grad_fn: Callable,
        topo: Topology,
        hps: Optional[object] = None,
        *,
        mixing: str = "sparse",
        seed: int = 0,
        scenario=None,
        faults=None,
        pacing=None,
        device=None,
    ) -> "BoundAlgorithm":
        """Close the spec over (grad_fn, topology, hps, mixing) on `device`
        (default ``cuda``).  Only the static network is ported: a dynamic
        scenario, a fault model or serving pacing that is not static
        raises."""
        for what, obj in (("scenario", scenario), ("faults", faults), ("pacing", pacing)):
            if obj is not None and not getattr(obj, "is_static", False):
                raise NotImplementedError(f"{what}= not yet ported to repro_torch")
        hps = self.hp_cls() if hps is None else hps
        if not isinstance(hps, self.hp_cls):
            raise TypeError(
                f"{self.name} expects {self.hp_cls.__name__}, got {type(hps).__name__}"
            )
        dev = resolve_device(device)
        extras = dict(self.setup(topo, hps, mixing, seed, dev)) if self.setup else {}
        if "hps" in extras:  # setup may rewrite hps (PaME's mixing field)
            hps = extras.pop("hps")
        ctx = AlgoContext(grad_fn=grad_fn, topo=topo, hps=hps, mixer=None,
                          extras=extras)
        return BoundAlgorithm(self, ctx, dev)

    def bind_batched(self, *args, **kwargs):
        raise NotImplementedError("bind_batched (lanes) not yet ported to repro_torch")


class BoundAlgorithm:
    """An Algorithm closed over (grad_fn, topology, hps): ``step(state,
    batch)`` is a plain closure the engine runs."""

    def __init__(self, spec: Algorithm, ctx: AlgoContext, device: torch.device):
        self.spec = spec
        self.ctx = ctx
        self.device = device

    @property
    def name(self) -> str:
        return self.spec.name

    @property
    def hps(self) -> object:
        return self.ctx.hps

    @property
    def params_of(self) -> Callable:
        return self.spec.params_of

    def init(self, key: int, params_stacked, batch0=None):
        if self.spec.needs_batch0 and batch0 is None:
            raise ValueError(f"{self.name} needs batch0 at init")
        return self.spec.init(key, params_stacked, self.ctx, batch0)

    def step(self, state, batch):
        return self.spec.step(state, batch, self.ctx)

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
        return tree_map(
            lambda x: x.to(self.device).unsqueeze(0)
            .expand((m,) + tuple(x.shape)).contiguous(),
            params0,
        )

    def _batches(self, batch_fn):
        return lambda k: tree_map(lambda x: x.to(self.device), batch_fn(k))

    def make_runner(self, *, objective_fn=None, tol_std: float = 1e-3,
                    chunk_size: int = engine.DEFAULT_CHUNK_SIZE) -> Callable:
        """Persistent chunked runner: ``run(key, params0, m, batch_fn,
        num_steps) -> (state, history)``."""
        runner = engine.make_scan_runner(
            self.step, objective_fn=objective_fn, params_of=self.spec.params_of,
            tol_std=tol_std, chunk_size=chunk_size,
        )

        def run(key, params0, m, batch_fn, num_steps):
            batch_fn = self._batches(batch_fn)
            batch0 = batch_fn(0) if self.spec.needs_batch0 else None
            state = self.init(key, self.stack_params(params0, m), batch0)
            state, metrics, info = runner(state, batch_fn, num_steps, copy_state=False)
            history = {k: [float(v) for v in vals] for k, vals in metrics.items()}
            history["loss"] = history.pop("loss_mean", [])
            history.update(info)
            self._account_wire(history, params0)
            return state, history

        return run

    def run(self, key, params0, m: int, batch_fn, num_steps: int, *,
            objective_fn=None, tol_std: float = 1e-3, driver: str = "scan",
            chunk_size: int = engine.DEFAULT_CHUNK_SIZE):
        """One-shot driver (scan or host), with wire accounting."""
        batch_fn = self._batches(batch_fn)
        batch0 = batch_fn(0) if self.spec.needs_batch0 else None
        state = self.init(key, self.stack_params(params0, m), batch0)
        if driver == "scan":
            state, metrics, info = engine.run_scan_loop(
                self.step, state, batch_fn, num_steps, objective_fn=objective_fn,
                params_of=self.spec.params_of, tol_std=tol_std, chunk_size=chunk_size,
            )
            history = engine.history_from(
                metrics, info, {"loss": "loss_mean", "objective": "objective"}
            )
        elif driver == "host":
            history = {"loss": [], "objective": []}
            f_window: list = []
            for k in range(num_steps):
                state, metrics = self.step(state, batch_fn(k))
                history["loss"].append(float(metrics["loss_mean"]))
                if objective_fn is not None:
                    mean = tree_map(lambda x: x.mean(dim=0), self.spec.params_of(state))
                    f_window.append(float(objective_fn(mean)))
                    history["objective"].append(f_window[-1])
                    if len(f_window) >= 3 and float(np.std(f_window[-3:])) < tol_std:
                        break
            history["steps_run"] = history["steps_dispatched"] = len(history["loss"])
        else:
            raise ValueError(f"unknown driver {driver!r}")
        self._account_wire(history, params0)
        return state, history

    def _account_wire(self, history: dict, params0) -> None:
        history["wire_bits_per_step"] = self.wire_bits_for(params0)
        history["wire_bits_total"] = history["wire_bits_per_step"] * history["steps_run"]


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
# PaME wire accounting (Eq. (8))
# ---------------------------------------------------------------------------
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
        state, batch, ctx.grad_fn, ctx.extras["topo_arrays"], ctx.hps),
    wire_bits=_pame_wire_bits,
    wire_bits_sizes=_pame_wire_bits_sizes,
    setup=_pame_setup,
))
