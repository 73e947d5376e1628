"""Carry weights across from the JAX package.

The JAX parameters arrive as a nested dict / list of numpy arrays (what
`jax.device_get` or `np.asarray` per leaf gives); the port keeps the same
tree with tensors for leaves.  bf16 arrays (numpy dtype named
``bfloat16``) are reinterpreted bit for bit, so no value is rounded on the
way.  `flatten` lists the leaves in JAX order: dict keys sorted, lists by
index (`repro_torch.tree`).
"""
from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map

__all__ = ["to_torch", "flatten"]


def _leaf_to_torch(x, device, dtype) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr).copy())
    return t.to(device=device, dtype=dtype or t.dtype)


def to_torch(
    tree,
    device: Optional[Union[str, torch.device]] = None,
    dtype: Optional[torch.dtype] = None,
):
    """The same tree with every leaf a tensor (on `device`, cast to `dtype`
    when given)."""
    return tree_map(lambda x: _leaf_to_torch(x, device, dtype), tree)


def flatten(tree) -> List:
    """Leaves in JAX `tree_flatten` order."""
    return tree_leaves(tree)
