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

`per_device_bytes` sums what each device of a layout would hold.

From placements to local pieces (the sharded PaME step, `core.pame`):

  * `MeshShardings` binds a placement tree to a
    `torch.distributed.device_mesh.DeviceMesh` whose dims are named
    ("node", "fsdp", "model") (`launch.mesh.make_logical_mesh`): the
    counterpart of JAX's tree of ``NamedSharding``s;
  * `cut` / `shard_tree` give a rank's piece of a leaf / a tree from its
    mesh coordinate, a dimension placed over several axes jointly taking
    JAX's order (the first axis named is the major one); `assemble` puts
    the pieces of every rank back together, and `gather_tree` does the
    same with collectives;
  * `all_gather` and `all_reduce` are the only collectives the port
    issues, plain `torch.distributed` calls on the mesh's groups (no
    DTensor: the kernels take plain tensors).  They count, per kind, the
    calls and the bytes with JAX's dry-run convention
    (``parse_collective_bytes``, `repro/launch/dryrun.py:78-88`, the
    result shape's bytes a device): an all-gather over g ranks counts its
    result, g × its input; an all-reduce 2 × its tensor.  A group of one
    rank still issues its call and counts 0 bytes, as XLA emits no
    collective over one device.  Each call is also counted under its use
    (``use=``: "exchange", "gradient", "metrics", "objective"), so that a
    record shows what the metrics cost beside the exchange.
    `collective_counts` reads the counts, `reset_collective_counts` sets
    them to 0.
  * `local_view(None, tree)` is the unsharded step's view: one rank
    holding every row whole, the collectives on it (``mesh`` None) the
    identity.  The exchanges and the step take one body for both.

Sharded serving (`models.prefill` / `decode_step`, ``shardings=``):

  * `serving_shardings` binds the mesh to the parameters' placements
    (`params_shardings(..., node_stacked=False)`), the batch's
    (`batch_shardings(..., node_stacked=False)`: rows over (node, fsdp)
    jointly where they divide) and the caches' (`cache_shardings(...,
    serving=True)`: rows only, whole over `model` on every rank);
  * `serve_view` gives the forward a `Serve` view: each layer's leaves are
    gathered over `fsdp` just before the layer runs (``use="weights"``)
    and dropped after it; over `model` the layers run tensor-parallel on
    the heads, columns and experts each rank owns, and a leaf whose piece
    does not line up with them (a column block cut inside a head, the fused
    Mamba projection) is gathered over `model` and that piece computed
    replicated.  `gathered_over_model` lists those leaves;
  * the serving uses: "weights" (the gathers over fsdp and the fallback
    gathers over model), "activations" (a row-parallel product's partial
    sums, the gated norm's sum of squares), "embed" (the vocab-parallel
    lookup), "logits" (the vocab slices gathered), "cache" (each rank's
    new K/V, SSM state and conv rows gathered into its whole cache) and
    "routing" (a MoE layer's per-expert counts gathered over the batch's
    rows, `Serve.rows_before`).
    `serve_view(None)` is the unsharded view: one rank, every collective
    the identity, every leaf whole.

The tensor-parallel train step (`core.pame` with a ``grad_fn`` that takes a
``view``; `models.train_loss(..., view)`):

  * `train_view` gives a node's loss the training form of the view: one
    node's placements (the node entry of each dropped), the batch's rows
    split over ``("fsdp",)`` as JAX places a node's rows, and every
    collective one that autograd sees (``Serve.train``);
  * a layer's gather over fsdp has a reduce-scatter for its backward
    (`reduce_scatter`, ``use="gradient"``: each fsdp rank used the weight
    on its own rows), and a leaf not placed over fsdp a sum over fsdp
    (``use="gradient"``); a sum over `model` (`Serve.psum`) has the
    identity, and a gather over `model` (`Serve.part`'s fallback, the
    vocab slices of `Serve.cat`) this rank's slice;
  * `Serve.enter` (identity forward, a sum over `model` backward,
    ``use="activations"``) is where a tensor every model rank holds whole
    enters a computation split over `model` (Megatron's f; the psum is its
    g): the gradient of a tensor that all model ranks hold whole is then
    whole on every rank;
  * `Serve.rows_sum` sums a loss term over the rows' ranks (identity
    backward: each rank's term is its own rows').
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

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
    "MeshShardings",
    "Local",
    "local_view",
    "node_ways",
    "node_rows",
    "leaf_specs",
    "AXES",
    "mesh_layout",
    "mesh_coords",
    "rank_coords",
    "spec_axes",
    "full_shape",
    "cut",
    "shard_tree",
    "assemble",
    "gather_dims",
    "gather_tree",
    "owns",
    "all_gather",
    "all_reduce",
    "reduce_scatter",
    "collective_counts",
    "reset_collective_counts",
    "ServingShardings",
    "serving_shardings",
    "Serve",
    "serve_view",
    "train_view",
    "gathered_over_model",
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


def cache_shardings(cache_shapes, layout: Layout, serving: bool = False):
    """KV / MLA / SSM cache trees: batch over (node, fsdp); heads over model.

    A named-tuple field's path ends in ``.name``, so the ``positions`` and
    head rules below never fire, as in JAX: every leaf, a ring's
    ``positions`` [L, C] included, is placed over its dim 1 only, which
    for ``positions`` cuts C.  With `serving` (a sharded serving step's
    caches), ``positions`` stay whole: every rank's ring needs them all
    (C · 4 bytes a layer)."""

    def one(path, leaf):
        shape = tuple(leaf.shape)
        axes: list = [None] * len(shape)
        name = path.rsplit("/", 1)[-1]
        if name == "positions" or (serving and name == ".positions"):
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
    leaves, specs, _ = _leaf_pairs(tree, placements)
    return [(x, spec) for x, spec in zip(leaves, specs) if isinstance(x, torch.Tensor)]


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


# ---------------------------------------------------------------------------
# from placements to local pieces
# ---------------------------------------------------------------------------
AXES = ("node", "fsdp", "model")


class MeshShardings(NamedTuple):
    """A placement tree bound to a (node, fsdp, model) `DeviceMesh`."""

    mesh: object   # torch.distributed.device_mesh.DeviceMesh
    specs: object  # the tree of placements (e.g. `state_shardings(...).params`)


class Local(NamedTuple):
    """A rank's view of a node-stacked tree under `MeshShardings`: the mesh,
    its layout and this rank's coordinate, each leaf's placement in JAX
    leaf order, the node count m and the rows r0 ... r0 + r - 1 this rank
    holds (its nodes).  Unsharded (`local_view(None, tree)`) the mesh is
    None, every placement None and r0 = 0, r = m: every row, whole."""

    mesh: object
    layout: Dict[str, int]
    coord: Dict[str, int]
    specs: list
    m: int
    r0: int
    r: int

    @property
    def sharded(self) -> bool:
        return self.mesh is not None

    def rows(self) -> slice:
        return slice(self.r0, self.r0 + self.r)

    def cut_trailing(self, x: torch.Tensor, spec: Placement) -> torch.Tensor:
        """This rank's piece of an [m, ...] tensor of the whole leaf's shape
        (all m rows kept: the senders' masks), contiguous."""
        return cut(x, spec, self.layout, self.coord, skip=(0,)).contiguous()


def local_view(shardings: Optional["MeshShardings"], tree) -> Local:
    """The `Local` view of this rank's pieces `tree` (leaves [m / node, ...],
    every leaf's dim 0 placed over "node"); with `shardings` None, the
    unsharded view of the whole tree."""
    if shardings is None:
        from repro_torch.tree import tree_leaves

        leaves = tree_leaves(tree)
        m = leaves[0].shape[0]
        return Local(None, dict.fromkeys(AXES, 1), dict.fromkeys(AXES, 0),
                     [(None,) * x.dim() for x in leaves], m, 0, m)
    leaves, specs, _ = _leaf_pairs(tree, shardings.specs)
    layout, coord = mesh_layout(shardings.mesh), mesh_coords(shardings.mesh)
    for spec in specs:
        if not spec or spec[0] != "node" or any(
                "node" in spec_axes(e) for e in spec[1:]):
            raise ValueError(f"a node-stacked leaf must be placed over 'node' on dim 0 "
                             f"alone, got {spec}")
    r = leaves[0].shape[0]
    return Local(shardings.mesh, layout, coord, specs, r * layout["node"],
                 coord["node"] * r, r)


def node_ways(shardings) -> int:
    """The ranks the nodes are split over: `shardings` is a `MeshShardings`,
    a rank's `Local` view, or None (1)."""
    if shardings is None:
        return 1
    if isinstance(shardings, Local):
        return shardings.m // shardings.r
    return mesh_layout(shardings.mesh)["node"]


def node_rows(shardings, m: int) -> slice:
    """The nodes r0 ... r0 + r - 1 of m whose rows the rank holds: node i is
    its local row i - r0 (`shardings` as `node_ways` takes it; None gives
    every node)."""
    ways = node_ways(shardings)
    if m % ways:
        raise ValueError(f"{m} nodes do not divide over {ways} node ranks")
    if isinstance(shardings, Local):
        if shardings.m != m:
            raise ValueError(f"the view covers {shardings.m} nodes, not {m}")
        return shardings.rows()
    r0 = 0 if shardings is None else mesh_coords(shardings.mesh)["node"] * (m // ways)
    return slice(r0, r0 + m // ways)


def mesh_layout(mesh) -> Dict[str, int]:
    """{"node", "fsdp", "model"} sizes of a mesh."""
    return {name: int(size) for name, size in zip(mesh.mesh_dim_names, mesh.mesh.shape)}


def mesh_coords(mesh) -> Dict[str, int]:
    """This rank's coordinate on each named dim of the mesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def rank_coords(rank: int, layout: Layout) -> Dict[str, int]:
    """The coordinate of `rank` in a row-major (node, fsdp, model) mesh of
    `layout` (how ``init_device_mesh`` and JAX's ``devices.reshape`` lay
    ranks out)."""
    out = {}
    for name in reversed(AXES):
        rank, out[name] = divmod(rank, layout[name])
    return {name: out[name] for name in AXES}


def spec_axes(entry) -> Tuple[str, ...]:
    """The axis names of one placement entry (None, a name or a tuple)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _ways(entry, layout: Layout) -> int:
    return math.prod(layout[name] for name in spec_axes(entry))


def _index(entry, layout: Layout, coord: Mapping[str, int]) -> int:
    idx = 0
    for name in spec_axes(entry):  # the first name is the major one
        idx = idx * layout[name] + coord[name]
    return idx


def full_shape(shape, spec: Placement, layout: Layout) -> Tuple[int, ...]:
    """The whole leaf's shape from a piece's shape and its placement."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(int(d) * _ways(e, layout) for d, e in zip(shape, spec))


def cut(x: torch.Tensor, spec: Placement, layout: Layout, coord: Mapping[str, int],
        skip: Sequence[int] = ()) -> torch.Tensor:
    """The piece of the whole tensor `x` a rank at `coord` holds under
    `spec` (a view), leaving the dims in `skip` whole."""
    for dim, entry in enumerate(spec):
        if dim in skip or entry is None:
            continue
        size = x.shape[dim] // _ways(entry, layout)
        x = x.narrow(dim, _index(entry, layout, coord) * size, size)
    return x


def leaf_specs(tree, placements) -> list:
    """Each leaf's placement in JAX leaf order, walked by `tree`'s structure."""
    return list(_placed_specs(tree, placements))


def _leaf_pairs(tree, placements):
    """(leaves, placements) in JAX leaf order, and the treedef."""
    from repro_torch.tree import tree_flatten

    leaves, treedef = tree_flatten(tree)
    return leaves, leaf_specs(tree, placements), treedef


def _placed_specs(tree, placements):
    """Each leaf's placement in JAX leaf order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _placed_specs(tree[k], placements[k])
    elif isinstance(tree, (list, tuple)):
        for t, p in zip(tree, placements):
            yield from _placed_specs(t, p)
    else:
        yield placements


def shard_tree(tree, placements, layout: Layout, coord: Mapping[str, int]):
    """`tree` with each tensor leaf cut to the piece of the rank at `coord`
    (a contiguous copy, so that a rank owns its piece); other leaves (a
    step counter, a key) are kept."""
    from repro_torch.tree import tree_unflatten

    leaves, specs, treedef = _leaf_pairs(tree, placements)
    return tree_unflatten(treedef, [
        cut(x, spec, layout, coord).contiguous() if isinstance(x, torch.Tensor) else x
        for x, spec in zip(leaves, specs)])


def assemble(pieces: Sequence, placements, layout: Layout):
    """The whole tree from every rank's piece (`pieces[rank]`, ranks in
    row-major mesh order): the inverse of `shard_tree` over all ranks."""
    from repro_torch.tree import tree_unflatten

    flat = [_leaf_pairs(p, placements) for p in pieces]
    leaves0, specs, treedef = flat[0]
    out = []
    for i, (x0, spec) in enumerate(zip(leaves0, specs)):
        if not isinstance(x0, torch.Tensor):
            out.append(x0)
            continue
        whole = x0.new_empty(full_shape(x0.shape, spec, layout))
        for rank, (leaves, _, _) in enumerate(flat):
            cut(whole, spec, layout, rank_coords(rank, layout)).copy_(leaves[i])
        out.append(whole)
    return tree_unflatten(treedef, out)


def owns(spec: Placement, coord: Mapping[str, int]) -> bool:
    """Whether the rank at `coord` is the one holder of its piece that a
    sum over all ranks should count: coordinate 0 on every mesh axis the
    placement does not split (its piece is replicated over those)."""
    used = {name for entry in spec for name in spec_axes(entry)}
    return all(coord.get(name, 0) == 0 for name in AXES if name not in used)


# ---------------------------------------------------------------------------
# collectives (counted)
# ---------------------------------------------------------------------------
_COUNTS: Dict[str, Dict[str, object]] = {}
# the leaves a serving step gathered over `model` (their paths, in order)
_GATHERED: Dict[str, None] = {}


def reset_collective_counts() -> None:
    """Set the counts, and the list of leaves gathered over `model`, to 0."""
    _COUNTS.clear()
    _GATHERED.clear()


def gathered_over_model() -> list:
    """The paths of the leaves the serving steps since the last reset
    gathered over `model` (their pieces do not line up with the heads,
    columns or experts a rank computes)."""
    return list(_GATHERED)


def collective_counts() -> Dict[str, Dict[str, object]]:
    """{kind: {"calls": n, "bytes": b, "by_use": {use: b}}}: what this
    process issued since the last reset (see the module's docstring)."""
    return {kind: dict(c, by_use=dict(c["by_use"])) for kind, c in _COUNTS.items()}


def _count(kind: str, use: str, g: int, nbytes: float) -> None:
    c = _COUNTS.setdefault(kind, {"calls": 0, "bytes": 0, "by_use": {}})
    nbytes = nbytes if g > 1 else 0
    c["calls"] += 1
    c["bytes"] += nbytes
    c["by_use"][use] = c["by_use"].get(use, 0) + nbytes


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int = 0, *,
               use: str = "other") -> torch.Tensor:
    """The pieces of `x` of every rank of the mesh's `axis` group, joined
    along `dim` in the group's order (`x` itself when `mesh` is None)."""
    if mesh is None:
        return x
    import torch.distributed as dist

    group = mesh.get_group(axis)
    g = dist.get_world_size(group)
    x0 = x.movedim(dim, 0).contiguous()
    out = x0.new_empty((g * x0.shape[0],) + tuple(x0.shape[1:]))
    # all_gather_single is all_gather_into_tensor's newer name (torch >= 2.13)
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, x0, group=group)
    _count("all_gather", use, g, out.numel() * out.element_size())
    return out.movedim(0, dim)


def all_reduce(x: torch.Tensor, mesh, axes: Sequence[str], op: str = "sum", *,
               use: str = "other") -> torch.Tensor:
    """`x` reduced in place over the ranks of each of the mesh's `axes`
    groups in turn ("sum" or "max"); `x` as it is when `mesh` is None."""
    if mesh is None:
        return x
    import torch.distributed as dist

    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    for axis in axes:
        group = mesh.get_group(axis)
        g = dist.get_world_size(group)
        dist.all_reduce(x, op=red, group=group)
        _count("all_reduce", use, g, 2 * x.numel() * x.element_size())
    return x


def reduce_scatter(x: torch.Tensor, mesh, axis: str, dim: int = 0, *,
                   use: str = "other") -> torch.Tensor:
    """`x` summed over the ranks of the mesh's `axis` group, each rank
    keeping its 1/g of the sum along `dim` (the group's order, as
    `all_gather` joins them); `x` itself when `mesh` is None.  Counted by
    its result, as JAX's convention counts a reduce-scatter."""
    if mesh is None:
        return x
    import torch.distributed as dist

    group = mesh.get_group(axis)
    g = dist.get_world_size(group)
    x0 = x.movedim(dim, 0).contiguous()
    out = x0.new_empty((x0.shape[0] // g,) + tuple(x0.shape[1:]))
    # reduce_scatter_single is reduce_scatter_tensor's newer name (torch >= 2.13)
    scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    scatter(out, x0, group=group)
    _count("reduce_scatter", use, g, out.numel() * out.element_size())
    return out.movedim(0, dim)


class _Gather(torch.autograd.Function):
    """`all_gather` over `axis`; backward "scatter" (a reduce-scatter: each
    rank used the whole tensor on its own rows) or "slice" (this rank's
    slice of a gradient that is whole on every rank)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim, use, back):
        ctx.args = (mesh, axis, dim, back, x.shape[dim])
        return all_gather(x, mesh, axis, dim, use=use)

    @staticmethod
    def backward(ctx, grad):
        mesh, axis, dim, back, n = ctx.args
        if back == "scatter":
            grad = reduce_scatter(grad, mesh, axis, dim, use="gradient")
        else:
            grad = grad.narrow(dim, mesh_coords(mesh)[axis] * n, n)
        return grad, None, None, None, None, None


class _Psum(torch.autograd.Function):
    """`all_reduce` (sum) over `axes`; backward the identity (the sum is
    used whole on every rank, its gradient whole on every rank)."""

    @staticmethod
    def forward(ctx, x, mesh, axes, use):
        x = x.clone()
        return all_reduce(x, mesh, axes, use=use)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None, None


class _Enter(torch.autograd.Function):
    """The identity; backward the gradient summed over `axis` (the ranks
    each used the tensor on their own part of a split computation)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, use):
        ctx.args = (mesh, axis, use)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        mesh, axis, use = ctx.args
        grad = grad.clone(memory_format=torch.contiguous_format)
        return all_reduce(grad, mesh, (axis,), use=use), None, None, None


def gather_dims(x: torch.Tensor, spec: Placement, mesh,
                axes: Optional[Sequence[str]] = None, *, use: str = "other") -> torch.Tensor:
    """`x` (a rank's piece) gathered whole along every dim `spec` places
    over `axes` (default all): a dim over several axes jointly is gathered
    over its minor axis first, which rebuilds JAX's order."""
    axes = AXES if axes is None else tuple(axes)
    for dim, entry in enumerate(spec):
        names = spec_axes(entry)
        if not names:
            continue
        if any(n not in axes for n in names):
            if any(n in axes for n in names):
                raise ValueError(f"dim {dim} is placed over {names} jointly; gather all "
                                 f"of them or none")
            continue
        for name in reversed(names):
            x = all_gather(x, mesh, name, dim, use=use)
    return x.contiguous()


def gather_tree(tree, shardings: MeshShardings, axes: Optional[Sequence[str]] = None, *,
                use: str = "other"):
    """`tree` (this rank's pieces) gathered whole over `axes` (default all)
    by collectives on `shardings.mesh`: every rank gets the same tree."""
    from repro_torch.tree import tree_unflatten

    leaves, specs, treedef = _leaf_pairs(tree, shardings.specs)
    return tree_unflatten(treedef, [
        gather_dims(x, spec, shardings.mesh, axes, use=use) if isinstance(x, torch.Tensor) else x
        for x, spec in zip(leaves, specs)])


# ---------------------------------------------------------------------------
# sharded serving
# ---------------------------------------------------------------------------
class ServingShardings(NamedTuple):
    """A sharded serving step's placements bound to a (node, fsdp, model)
    `DeviceMesh`: the parameters', the batch's and the caches' trees."""

    mesh: object
    params: object
    batch: object = None
    caches: object = None


def serving_shardings(mesh, params, batch=None, caches=None) -> ServingShardings:
    """The placements of a serving step over `mesh` from the whole trees'
    shapes (tensors or meta stand-ins): parameters unstacked
    (``node_stacked=False``), the batch's rows over (node, fsdp), the
    caches' rows likewise (`cache_shardings(..., serving=True)`)."""
    layout = mesh_layout(mesh)
    return ServingShardings(
        mesh, params_shardings(params, layout, node_stacked=False),
        None if batch is None else batch_shardings(batch, layout, node_stacked=False),
        None if caches is None else cache_shardings(caches, layout, serving=True))


class Serve(NamedTuple):
    """A rank's view of a serving step or of a node's loss: the mesh (None
    unsharded), its layout, this rank's coordinate, the parameters'
    placement tree (None unsharded), the axes the batch's rows are split
    over (None where the batch's placement was not given and node · fsdp >
    1), the path of the block being run (for `gathered_over_model`) and
    whether it is the training form (`train_view`: every collective has its
    backward, and a node's loss terms are summed over the rows' ranks)."""

    mesh: object
    layout: Dict[str, int]
    coord: Dict[str, int]
    specs: object = None
    rows: Optional[Tuple[str, ...]] = ()
    path: str = ""
    train: bool = False

    @property
    def sharded(self) -> bool:
        return self.mesh is not None

    @property
    def t(self) -> int:
        """The `model` axis' size."""
        return self.layout["model"]

    @property
    def r(self) -> int:
        """This rank's coordinate on `model`."""
        return self.coord["model"]

    @property
    def pieces(self) -> int:
        """The number of pieces the batch's rows are split into."""
        return math.prod(self.layout[name] for name in self.rows or ())

    def at(self, path: str) -> "Serve":
        """The view inside the block at `path` (a path of the parameter tree)."""
        return self._replace(path=path)

    def heads(self, n: int) -> Tuple[int, int]:
        """The [lo, hi) of n heads (or experts) this rank computes: its
        n / t when t divides n, else all n (computed replicated)."""
        if n % self.t:
            return 0, n
        return self.r * n // self.t, (self.r + 1) * n // self.t

    def span(self, w: torch.Tensor, dim: int, whole: int) -> Tuple[int, int]:
        """The [lo, hi) of the whole leaf's dim `dim` (of size `whole`)
        that this rank's piece `w` holds: all of it, or its 1/t over
        `model`."""
        n = w.shape[dim]
        return (0, whole) if n == whole else (self.r * n, (self.r + 1) * n)

    def part(self, w: torch.Tensor, dim: int, whole: int, lo: int, hi: int,
             name: str) -> torch.Tensor:
        """[lo, hi) of the whole leaf `name` along `dim`, from this rank's
        piece `w` (a view where the piece holds it; otherwise the leaf is
        gathered over `model`, counted under "weights" and listed in
        `gathered_over_model`; in training its gradient is then whole on
        every rank and the backward keeps this rank's slice, the part of a
        split range entering through `enter`)."""
        plo, phi = self.span(w, dim, whole)
        if plo <= lo and hi <= phi:
            return w if (lo, hi) == (plo, phi) else w.narrow(dim, lo - plo, hi - lo)
        _GATHERED[f"{self.path}/{name}" if self.path else name] = None
        if not self.train:
            return all_gather(w, self.mesh, "model", dim, use="weights").narrow(dim, lo, hi - lo)
        w = _Gather.apply(w, self.mesh, "model", dim, "weights", "slice")
        return w if (lo, hi) == (0, whole) else self.enter(w).narrow(dim, lo, hi - lo)

    def psum(self, x: torch.Tensor, use: str = "activations") -> torch.Tensor:
        """`x` summed over `model` (in place, in its own type; in training
        a new tensor, its backward the identity)."""
        if self.t == 1:
            return x
        if self.train:
            return _Psum.apply(x, self.mesh, ("model",), use)
        return all_reduce(x, self.mesh, ("model",), use=use)

    def cat(self, x: torch.Tensor, dim: int, use: str) -> torch.Tensor:
        """The ranks' pieces of `x` joined along `dim` over `model` (in
        training, the backward keeps this rank's slice)."""
        if self.t == 1:
            return x
        if self.train:
            return _Gather.apply(x, self.mesh, "model", dim, use, "slice")
        return all_gather(x, self.mesh, "model", dim, use=use)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """`x`, which every model rank holds whole, where it enters a
        computation split over `model`: in training its gradient is summed
        over `model` (``use="activations"``); otherwise `x` itself."""
        if self.t == 1 or not self.train:
            return x
        return _Enter.apply(x, self.mesh, "model", "activations")

    def rows_sum(self, x: torch.Tensor, use: str = "activations") -> torch.Tensor:
        """A node's loss term `x` over this rank's rows summed over the
        rows' ranks (identity backward); `x` itself with the rows whole."""
        if not self.rows:
            return x
        return _Psum.apply(x, self.mesh, self.rows, use)

    def weights(self, tree, specs, skip: int = 0):
        """`tree` (this rank's pieces) gathered whole over `fsdp` by the
        placements `specs`, each placement's first `skip` entries dropped
        (a layer of a stacked tree): what one layer uses, gathered just
        before it runs.  In training a gathered leaf's gradient is
        reduce-scattered over fsdp and that of a leaf not placed over fsdp
        summed over fsdp.  Unsharded, or with one rank on `fsdp`, `tree`
        itself."""
        if not self.sharded or specs is None or self.layout["fsdp"] == 1:
            return tree
        from repro_torch.tree import tree_unflatten

        leaves, pl, treedef = _leaf_pairs(tree, specs)
        return tree_unflatten(treedef, [
            self._fsdp_whole(x, spec[skip:]) if isinstance(x, torch.Tensor) else x
            for x, spec in zip(leaves, pl)])

    def _fsdp_whole(self, x: torch.Tensor, spec: Placement) -> torch.Tensor:
        placed = [dim for dim, e in enumerate(spec) if "fsdp" in spec_axes(e)]
        if not self.train:
            return gather_dims(x, spec, self.mesh, ("fsdp",), use="weights") if placed else x
        if not placed:
            return _Enter.apply(x, self.mesh, "fsdp", "gradient")
        (dim,) = placed
        if spec_axes(spec[dim]) != ("fsdp",):
            raise ValueError(f"dim {dim} is placed over {spec[dim]} jointly")
        return _Gather.apply(x, self.mesh, "fsdp", dim, "weights", "scatter")

    def rows_before(self, counts: torch.Tensor) -> Tuple[torch.Tensor, int]:
        """(`counts` [n], a count over this rank's rows of the batch,
        summed over the ranks that hold the rows before them; the number of
        pieces the rows are split into).  The counts are gathered over the
        rows' axes (``use="routing"``); with the rows whole, zeros and 1."""
        if self.rows is None:
            raise ValueError("this step needs the batch's placement: "
                             "serving_shardings(mesh, params, batch)")
        if not self.rows:
            return torch.zeros_like(counts), 1
        every = gather_dims(counts[None], (self.rows, None), self.mesh, self.rows,
                            use="routing")
        return every[:_index(self.rows, self.layout, self.coord)].sum(0), every.shape[0]

    def sub(self, *keys):
        """The placements under `keys` of the parameter tree (None unsharded)."""
        specs = self.specs
        if specs is None:
            return None
        for k in keys:
            specs = specs[k]
        return specs


def serve_view(shardings: Optional[ServingShardings]) -> Serve:
    """The `Serve` view of `shardings`; with None, the unsharded view (one
    rank, every collective the identity)."""
    if shardings is None:
        return Serve(None, dict.fromkeys(AXES, 1), dict.fromkeys(AXES, 0))
    layout = mesh_layout(shardings.mesh)
    if shardings.batch is not None:  # every leaf's rows lie alike
        spec = shardings.batch
        rows = spec_axes((next(iter(spec.values())) if isinstance(spec, dict) else spec)[0])
    else:
        rows = () if layout["node"] * layout["fsdp"] == 1 else None
    return Serve(shardings.mesh, layout, mesh_coords(shardings.mesh), shardings.params, rows)


def train_view(loc: Optional[Local] = None, treedef=None) -> Serve:
    """The training form of the view for one node of the sharded PaME step:
    `loc` (a `local_view`) with each placement's node entry dropped (`treedef`
    the parameter tree's structure), the node's rows split over fsdp where
    fsdp > 1 (the batch placed as `batch_shardings(..., node_stacked=True)`
    places it).  With `loc` None or unsharded, the unsharded training view."""
    if loc is None or not loc.sharded:
        return Serve(None, dict.fromkeys(AXES, 1), dict.fromkeys(AXES, 0), train=True)
    from repro_torch.tree import tree_unflatten

    specs = tree_unflatten(treedef, [tuple(spec[1:]) for spec in loc.specs])
    rows = ("fsdp",) if loc.layout["fsdp"] > 1 else ()
    return Serve(loc.mesh, loc.layout, loc.coord, specs, rows, train=True)
