"""Minimal functional optimizers (port of `repro.optim.optimizers`).

Init / update pairs over the port's trees of tensors, as in JAX:
``update(grads, state, params) -> (updates, new_state)``, then
``apply_updates(params, updates)``.  Nothing is updated in place, and no
`torch.optim` object holds the state.  PaME itself needs none (its update
is a sigma-scheduled gradient step).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map

__all__ = ["Optimizer", "sgd", "momentum", "adam", "apply_updates"]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[object], object]
    update: Callable[[object, object, object], Tuple[object, object]]
    # update(grads, state, params) -> (updates, new_state)


def _weak(c: float, x: torch.Tensor) -> torch.Tensor:
    """A Python scalar in x's type, as JAX's weak typing casts it before
    the product (torch would multiply by the scalar at f32 precision)."""
    return torch.tensor(c, dtype=x.dtype, device=x.device)


def apply_updates(params: object, updates: object) -> object:
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def sgd(lr: float) -> Optimizer:
    return Optimizer(
        init=lambda params: (),
        update=lambda g, s, p: (tree_map(lambda x: _weak(-lr, x) * x, g), s),
    )


def momentum(lr: float, beta: float = 0.9) -> Optimizer:
    def init(params):
        return tree_map(torch.zeros_like, params)

    def update(grads, state, params):
        new_m = tree_map(lambda m, g: _weak(beta, m) * m + g, state, grads)
        return tree_map(lambda m: _weak(-lr, m) * m, new_m), new_m

    return Optimizer(init, update)


class AdamState(NamedTuple):
    mu: object
    nu: object
    count: torch.Tensor  # int32 scalar


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    def init(params):
        zeros = lambda: tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)  # noqa: E731
        dev = tree_leaves(params)[0].device
        return AdamState(zeros(), zeros(), torch.zeros((), dtype=torch.int32, device=dev))

    def update(grads, state, params):
        count = state.count + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(), state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()), state.nu, grads)
        # bias corrections in f32, as JAX computes them
        c = count.float()
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32, device=c.device) ** c
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32, device=c.device) ** c
        updates = tree_map(lambda m, v: -lr * (m / bc1) / (torch.sqrt(v / bc2) + eps), mu, nu)
        return updates, AdamState(mu, nu, count)

    return Optimizer(init, update)
