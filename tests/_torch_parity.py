"""Helpers shared by the tests/test_torch_*.py parity suites.

JAX's threefry streams cannot be reproduced from torch, so parity runs the
JAX step with its own key and recomputes the same draws outside it (the
same fold_in chain as `repro.core.pame.pame_step`), then hands them to the
port as injected draws.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import pme as jpme


def to_t(x, dtype=None):
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    t = torch.from_numpy(np.array(arr))
    return t if dtype is None else t.to(dtype)


def to_np(t):
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def jax_step_draws(key, step, params, topo_arrays, cfg):
    """The selection and per-leaf masks `repro.core.pame.pame_step` draws at
    `step` from `key`, as torch tensors in the port's `draws=` format."""
    k_sel, k_mask = (jax.random.fold_in(key, step * 3 + i) for i in range(2))
    comm = (jnp.asarray(step, jnp.int32) % topo_arrays.kappa) == 0
    leaves = jax.tree_util.tree_leaves(params)
    m = leaves[0].shape[0]
    if cfg.partition == "tree":
        rates = jpme.leaf_rates(len(leaves), cfg.p, cfg.p_leaf)
    else:
        rates = (cfg.p,) * len(leaves)
    masks = []
    for idx, (leaf, p_i) in enumerate(zip(leaves, rates)):
        lkey = jax.random.fold_in(k_mask, idx)
        if cfg.mask_mode == "exact":
            n = int(np.prod(leaf.shape[1:]))
            mk = jpme.sample_coordinate_masks(
                lkey, m, n, max(1, int(round(p_i * n))), mode="exact")
        else:
            mk = jax.random.bernoulli(lkey, p_i, leaf.shape)
        masks.append(to_t(mk))
    args = (k_sel, topo_arrays.nbrs, topo_arrays.valid, topo_arrays.t, comm)
    if cfg.mixing == "sparse":
        return {"sel": to_t(jpme.sample_neighbor_selection_padded(*args)), "masks": masks}
    return {"a": to_t(jpme.sample_neighbor_selection(*args)), "masks": masks}
