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


# fold_in tags of each baseline's compressions in `repro.core.baselines`,
# under the port's `draws=` names
COMPRESSION_TAGS = {"choco": {"q": 7}, "beer": {"h": 3, "z": 5}, "anq_nids": {"q": 11}}


def jax_compression_draws(name, key, step, params):
    """The uniforms baseline `name`'s step `step` draws for its compressions
    (`_compress_tree`: fold_in(fold_in(fold_in(key, step), tag), leaf)),
    one [m, n] tensor per leaf: f32 for rand-k, the leaf's type for QSGD
    (`jax.random.bernoulli` draws in the type of its probability)."""
    k = jax.random.fold_in(key, step)
    leaves = jax.tree_util.tree_leaves(params)
    draws = {}
    for field, tag in COMPRESSION_TAGS.get(name, {}).items():
        kt = jax.random.fold_in(k, tag)
        draws[field] = [
            to_t(jax.random.uniform(
                jax.random.fold_in(kt, idx),
                (leaf.shape[0], int(np.prod(leaf.shape[1:]))),
                leaf.dtype if name == "anq_nids" else jnp.float32,
            ))
            for idx, leaf in enumerate(leaves)
        ]
    return draws


def jax_step_draws(key, step, params, topo_arrays, cfg):
    """The selection and per-leaf masks (dense exchange) or class offsets
    (compressed exchange) `repro.core.pame.pame_step` draws at `step` from
    `key`, as torch tensors in the port's `draws=` format."""
    k_sel, k_mask = (jax.random.fold_in(key, step * 3 + i) for i in range(2))
    comm = (jnp.asarray(step, jnp.int32) % topo_arrays.kappa) == 0
    leaves = jax.tree_util.tree_leaves(params)
    m = leaves[0].shape[0]
    args = (k_sel, topo_arrays.nbrs, topo_arrays.valid, topo_arrays.t, comm)
    if cfg.exchange != "dense":
        from repro.core.gossip import systematic_offsets

        k = max(2, int(round(1.0 / cfg.p)))
        offsets = [to_t(systematic_offsets(jax.random.fold_in(k_mask, idx), m, k))
                   for idx in range(len(leaves))]
        return {"a": to_t(jpme.sample_neighbor_selection(*args)), "offsets": offsets}
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
    if cfg.mixing == "sparse":
        return {"sel": to_t(jpme.sample_neighbor_selection_padded(*args)), "masks": masks}
    return {"a": to_t(jpme.sample_neighbor_selection(*args)), "masks": masks}
