"""The (node, fsdp, model) layout of N devices (port of `repro.launch.mesh`).

Every arch sees the devices as (node, fsdp, model): DFL nodes live on
`node`; each node's replica is `model`-way tensor parallel and `fsdp`-way
weight-sharded.  `fsdp` grows (and `node` shrinks) for archs whose per-node
state (params + grads + PME buffer, ~3x the parameters in bf16) would not
fit `model` devices' parameter budget.

The JAX module builds `jax.sharding.Mesh` objects over a TPU pod and
carries that chip's memory and model axis as constants.  Here only the
arithmetic is ported, and the per-device parameter budget, the model axis
and the state multiplier are arguments: the dry run passes the card's own
memory.  A step executed sharded over several cards (torch.distributed's
DeviceMesh and DTensor over `repro_torch.sharding`'s placements) is not
part of the port yet: its paths run on one card.
"""
from __future__ import annotations

import math
from typing import Dict

from repro_torch.models.config import ModelConfig

__all__ = ["fsdp_degree", "logical_layout", "STATE_MULTIPLIER"]

STATE_MULTIPLIER = 3.0  # params + grads + PME aggregate (no optimizer state)


def fsdp_degree(cfg: ModelConfig, total_devices: int, *, model_axis: int,
                param_budget: float, state_multiplier: float = STATE_MULTIPLIER) -> int:
    """Smallest power-of-two fsdp that fits `state_multiplier` x the bf16
    parameters of one node in `model_axis` x `param_budget` bytes, capped so
    that at least 2 DFL nodes remain."""
    param_bytes = cfg.param_count() * 2  # bf16
    need = state_multiplier * param_bytes / (model_axis * param_budget)
    fsdp = 1 if need <= 1 else 2 ** math.ceil(math.log2(need))
    max_fsdp = total_devices // (model_axis * 2)  # keep >= 2 DFL nodes
    return int(max(1, min(fsdp, max_fsdp)))


def logical_layout(cfg: ModelConfig, total_devices: int, *, model_axis: int,
                   param_budget: float,
                   state_multiplier: float = STATE_MULTIPLIER) -> Dict[str, int]:
    """{"node", "fsdp", "model"} sizes over `total_devices`, the shape of
    JAX's `make_logical_mesh` (node may be 0 when fewer than `model_axis`
    devices are given, as there)."""
    fsdp = fsdp_degree(cfg, total_devices, model_axis=model_axis, param_budget=param_budget,
                       state_multiplier=state_multiplier)
    return {"node": total_devices // (fsdp * model_axis), "fsdp": fsdp, "model": model_axis}
