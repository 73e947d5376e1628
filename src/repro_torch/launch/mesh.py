"""The (node, fsdp, model) layout of N devices (port of `repro.launch.mesh`).

Every arch sees the devices as (node, fsdp, model): DFL nodes live on
`node`; each node's replica is `model`-way tensor parallel and `fsdp`-way
weight-sharded.  `fsdp` grows (and `node` shrinks) for archs whose per-node
state (params + grads + PME buffer, ~3x the parameters in bf16) would not
fit `model` devices' parameter budget.

The meshes are `torch.distributed.device_mesh.DeviceMesh`es over the
ranks of the default process group, which the caller initialises (NCCL on
the cards, gloo on the CPU, torch's fake group for the dry run) and whose
device type the caller names: ``"cuda"`` on the card, ``"cpu"`` when it
asks for the CPU.  `make_logical_mesh` lays the ranks out row-major as
(node, fsdp, model), as JAX reshapes its device array; the sharded PaME
step (`core.pame`, through `repro_torch.sharding`) runs on it.

What has no counterpart here:

  * ``mesh_axis_kwargs`` pins JAX's mesh axes to ``AxisType.Auto``; a
    DeviceMesh has no axis types (its collectives are the caller's
    explicit calls), so there is nothing to pin;
  * ``HBM_PER_CHIP``, ``PER_CHIP_PARAM_BUDGET`` and ``MODEL_AXIS`` are a
    TPU v5e chip's memory and the pod's model axis.  The card's memory is
    read from the card (or passed, as the dry run's ``--device-bytes``),
    and the parameter budget, the model axis and the state multiplier are
    arguments of `fsdp_degree` / `logical_layout`;
  * JAX's production mesh is a fixed (data, model) TPU slice of 16 × 16
    chips (two pods: 2 × 16 × 16); `make_production_mesh` is the flat
    mesh of however many ranks the process group has.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

from repro_torch.models.config import ModelConfig

__all__ = ["fsdp_degree", "logical_layout", "make_production_mesh", "make_logical_mesh",
           "STATE_MULTIPLIER"]

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


def make_production_mesh(device_type: str = "cuda"):
    """The flat mesh ("data",) over every rank of the default process
    group, on `device_type` ("cuda", or "cpu" for gloo and the fake group)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (dist.get_world_size(),), mesh_dim_names=("data",))


def make_logical_mesh(cfg: Optional[ModelConfig] = None, *, device_type: str = "cuda",
                      layout: Optional[Dict[str, int]] = None, model_axis: int = 1,
                      param_budget: Optional[float] = None):
    """The (node, fsdp, model) view of the default process group's ranks,
    row-major over `layout` ({"node", "fsdp", "model"}: a test asks for 4 ×
    1 × 2 as JAX's does) or, when it is None, over `logical_layout(cfg,
    world size, ...)` (needs `param_budget`, a card's bytes for parameters).
    The sizes must multiply to the world size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if layout is None:
        if cfg is None or param_budget is None:
            raise ValueError("give the layout, or the config and the parameter budget")
        layout = logical_layout(cfg, world, model_axis=model_axis, param_budget=param_budget)
    shape = tuple(int(layout[k]) for k in ("node", "fsdp", "model"))
    if math.prod(shape) != world:
        raise ValueError(f"layout {layout} does not cover the {world} ranks")
    return init_device_mesh(device_type, shape, mesh_dim_names=("node", "fsdp", "model"))
