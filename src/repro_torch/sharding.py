"""Placement rules for every parameter / cache / batch leaf (port of
`repro.sharding`).

A layout is an ordered mapping of axis names to sizes, {"node": n, "fsdp":
f, "model": t} (`launch.mesh.logical_layout`).  A placement is the
counterpart of JAX's ``PartitionSpec``: a tuple with one entry a dimension,
an axis name, a tuple of names (one dimension over several axes jointly)
or None (replicated).  Rules are keyed on leaf path names and give the
*trailing* dims' axes; extra leading dims (layer stack, DFL node axis) are
padded with None and the node axis (training) gets "node".  Every proposed
axis is dropped if it does not divide its dimension, so the same rules
serve all ten archs.

Paths read as JAX's: dict keys, list indices, and a named tuple's field as
``.name`` (how jax.tree_util prints its attribute key).  The cache rules
keyed on the last path part ("k", "v", "state", "conv", "positions") thus
meet ".k" and do not fire, in JAX and here alike: cache leaves place only
their batch dimension.

Placements are data: nothing here moves a tensor.  `per_device_bytes`
sums what each device of a layout would hold.
"""
from __future__ import annotations

from typing import Callable, Mapping, Tuple

import torch

__all__ = [
    "fit_spec",
    "param_spec",
    "params_shardings",
    "batch_shardings",
    "cache_shardings",
    "state_shardings",
    "per_device_bytes",
    "RULE_OVERRIDES",
]

Layout = Mapping[str, int]
Placement = Tuple[object, ...]

# trailing-dims rules: substring of the leaf path -> tuple of axis names
# (a tuple entry may itself list fallbacks tried in order)
_RULES: Tuple[Tuple[str, Tuple[object, ...]], ...] = (
    ("embed", ("model", "fsdp")),
    ("lm_head", ("fsdp", "model")),
    ("vision_proj", (None, "fsdp")),
    # attention
    ("attn/wq", ("fsdp", "model")),
    ("attn/wk", ("fsdp", "model")),
    ("attn/wv", ("fsdp", "model")),
    ("attn/wo", ("model", "fsdp")),
    ("attn/w_dq", ("fsdp", None)),
    ("attn/w_uq", ("fsdp", "model")),
    ("attn/w_dkv", ("fsdp", None)),
    ("attn/w_uk", (None, "model")),
    ("attn/w_uv", (None, "model")),
    # dense mlp & shared experts
    ("mlp/w_gate", ("fsdp", "model")),
    ("mlp/w_up", ("fsdp", "model")),
    ("mlp/w_down", ("model", "fsdp")),
    ("shared/w_gate", ("fsdp", "model")),
    ("shared/w_up", ("fsdp", "model")),
    ("shared/w_down", ("model", "fsdp")),
    # routed experts: expert-parallel over `model`
    ("moe/router", ("fsdp", None)),
    ("moe/w_gate", ("model", "fsdp", None)),
    ("moe/w_up", ("model", "fsdp", None)),
    ("moe/w_down", ("model", None, "fsdp")),
    # mamba (fused in_proj baseline; split-proj leaves shard head-aligned)
    ("mamba/in_proj", ("fsdp", "model")),
    ("mamba/in_z", ("fsdp", "model")),
    ("mamba/in_x", ("fsdp", "model")),
    ("mamba/in_B", ("fsdp", None)),
    ("mamba/in_C", ("fsdp", None)),
    ("mamba/in_dt", ("fsdp", "model")),
    ("mamba/out_proj", ("model", "fsdp")),
    ("mamba/conv_x_w", (None, "model")),
    ("mamba/conv_x_b", ("model",)),
    ("mamba/conv_B_w", (None, None)),
    ("mamba/conv_C_w", (None, None)),
    ("mamba/conv_w", (None, "model")),
    ("mamba/conv_b", ("model",)),
)

# experiment hook: {"pattern": axes} entries that take precedence over
# _RULES (set by the dry run's --variant; empty in production)
RULE_OVERRIDES: dict = {}


def fit_spec(axes: Tuple[object, ...], shape: Tuple[int, ...], layout: Layout) -> Placement:
    """Drop axes that don't divide their dim; pad/truncate to rank."""
    out = []
    rank = len(shape)
    padded = (None,) * (rank - len(axes)) + tuple(axes)
    for dim, ax in zip(shape, padded[:rank]):
        if ax is None:
            out.append(None)
            continue
        candidates = ax if isinstance(ax, (list, tuple)) else (ax,)
        chosen = None
        for c in candidates:
            if c in layout and dim % layout[c] == 0 and layout[c] > 1:
                chosen = c
                break
        out.append(chosen)
    # an axis may appear only once in a placement
    seen = set()
    for i, ax in enumerate(out):
        if ax is None:
            continue
        if ax in seen:
            out[i] = None
        else:
            seen.add(ax)
    return tuple(out)


def param_spec(path: str, shape: Tuple[int, ...], layout: Layout,
               node_stacked: bool) -> Placement:
    rule: Tuple[object, ...] = ()
    for pattern, axes in RULE_OVERRIDES.items():
        if pattern in path:
            rule = axes
            break
    else:
        for pattern, axes in _RULES:
            if pattern in path:
                rule = axes
                break
    spec = list(fit_spec(rule, tuple(shape), layout))
    if node_stacked and spec and "node" in layout and shape[0] % layout["node"] == 0:
        spec[0] = "node"
    return tuple(spec)


def _map_with_path(fn: Callable, tree, path: Tuple[str, ...] = ()):
    """`tree` with each leaf replaced by ``fn("a/b/c", leaf)``: dict keys,
    list / tuple indices and named-tuple fields (``.name``) make the path.
    A leaf is anything else (a tensor, a number)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, v, path + (f".{f}",))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),)) for i, v in enumerate(tree))
    return fn("/".join(path), tree)


def params_shardings(params_shapes, layout: Layout, node_stacked: bool):
    """Tensor tree -> the same tree of placements."""
    return _map_with_path(
        lambda p, leaf: param_spec(p, tuple(leaf.shape), layout, node_stacked), params_shapes)


def _joint_batch_axis(b: int, layout: Layout):
    nf = layout["node"] * layout["fsdp"]
    if b % nf == 0:
        return ("node", "fsdp") if layout["fsdp"] > 1 else "node"
    if b % layout["node"] == 0:
        return "node"
    return None


def batch_shardings(batch_shapes, layout: Layout, node_stacked: bool):
    """tokens [m, b, s] -> (node, fsdp, None); serving [b, s] -> ((node,
    fsdp), ...)."""

    def one(path, leaf):
        shape = tuple(leaf.shape)
        axes: list = [None] * len(shape)
        if node_stacked:
            if shape and shape[0] % layout["node"] == 0:
                axes[0] = "node"
            if len(shape) > 1 and shape[1] % layout["fsdp"] == 0 and layout["fsdp"] > 1:
                axes[1] = "fsdp"
            return tuple(axes)
        # serving: batch over (node, fsdp) jointly if divisible
        if shape:
            axes[0] = _joint_batch_axis(shape[0], layout)
        return tuple(axes)

    return _map_with_path(one, batch_shapes)


def cache_shardings(cache_shapes, layout: Layout):
    """KV / MLA / SSM cache trees: batch over (node, fsdp); heads over model."""

    def one(path, leaf):
        shape = tuple(leaf.shape)
        axes: list = [None] * len(shape)
        name = path.rsplit("/", 1)[-1]
        if name == "positions":
            return tuple(axes)
        # the batch dim follows the layer-stack axis: caches are [L, B, ...]
        bpos = 1 if len(shape) >= 2 else 0
        axes[bpos] = _joint_batch_axis(shape[bpos], layout)
        if name in ("k", "v") and len(shape) >= 4:
            # [L, B, C, KV, hd]
            if shape[-2] % layout["model"] == 0:
                axes[-2] = "model"
            elif shape[-1] % layout["model"] == 0:
                axes[-1] = "model"
        if name == "state" and len(shape) >= 4 and shape[2] % layout["model"] == 0:
            axes[2] = "model"  # [L, B, H, P, N]
        if name == "conv" and len(shape) >= 3 and shape[-1] % layout["model"] == 0:
            axes[-1] = "model"
        return tuple(axes)

    return _map_with_path(one, cache_shapes)


def state_shardings(state_shapes, layout: Layout):
    """PaMEState: params node-stacked; sigma [m] over node; step and key
    replicated."""
    sigma = ("node",) if state_shapes.sigma.shape[0] % layout["node"] == 0 else (None,)
    return type(state_shapes)(
        params=params_shardings(state_shapes.params, layout, node_stacked=True),
        sigma=sigma, step=(), key=(),
    )


def _placed(tree, placements):
    """(tensor, placement) pairs of `tree` and its placement tree, walked
    by `tree`'s structure (a placement is itself a tuple)."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _placed(tree[k], placements[k])
    elif isinstance(tree, (list, tuple)):
        for t, p in zip(tree, placements):
            yield from _placed(t, p)
    elif isinstance(tree, torch.Tensor):
        yield tree, placements


def per_device_bytes(tree, placements, layout: Layout) -> int:
    """Bytes one device holds of `tree`'s tensors placed by `placements`
    (the same tree of placements) over `layout`: each leaf's bytes over the
    product of the sizes of the axes it is split across."""
    total = 0
    for leaf, spec in _placed(tree, placements):
        ways = 1
        for ax in spec:
            for name in (ax if isinstance(ax, tuple) else (ax,)):
                if name is not None:
                    ways *= layout[name]
        total += leaf.numel() * leaf.element_size() // ways
    return total
