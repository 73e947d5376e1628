"""Compressed PME exchange with block-systematic sampling (port of
`repro.core.gossip`).

Each leaf's axis 1 (the layer axis of a block stack, the vocab axis of an
embedding) is split into k = round(1/p) contiguous classes, padded when
d1 % k ≠ 0; node j transmits exactly class o_j, an offset drawn per round,
so the payload is one contiguous slab of n/k coordinates:

  * every coordinate is selected with probability exactly 1/k = p, so
    Theorem 1's count-weighted estimator stays unbiased;
  * lambda_{i,c} = |{j in N_i^k : o_j = c}| is a tiny [m, k] count matrix;
  * ``quantize_bits=8`` sends the slab as int8 with one f32 absmax scale
    per message, dequantised before averaging.

Within a round coordinates move in blocks rather than as independent
draws; across rounds every coordinate is exchanged at the same rate.  This
exchange runs no Pallas kernel in JAX: its [m, m] × [m, n/k] contractions
are `torch.einsum` here, in f32 as JAX's ``preferred_element_type`` asks.

Sharded (``shardings=``, a `repro_torch.sharding.MeshShardings`), as JAX's
module runs over a (node, fsdp, model) mesh: each rank holds its nodes'
rows and its fsdp / model piece of every leaf.  A leaf is blocked along
its first trailing axis that the placement leaves whole and that has at
least min(k, 2) entries (JAX's rule: splitting a placed axis would move
the whole leaf), and only the [m, n/k] payloads cross the wire: each
rank all-gathers its piece of them over ``node`` (int8 and one f32 scale
a message under q8, the scale the absmax over the whole payload, reduced
over the ranks that hold its pieces).  Where every trailing axis is
placed or too short, JAX blocks along axis 1 all the same; the port then
gathers the rank's rows whole over fsdp and model first.  On leaves whose
axis 1 is placed the sharded exchange blocks along another axis than the
unsharded one, so the two differ once the nodes' rows differ (ROADMAP,
queue 3): the port follows JAX's sharded exchange.  The unsharded
exchange is the same body on `sharding.local_view(None, ...)` (every row a
receiver, the gathers the identity), blocked along axis 1 as JAX's.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch import sharding as shd
from repro_torch.core.pme import fold_in, make_generator
from repro_torch.tree import tree_flatten, tree_unflatten

__all__ = ["compressed_pme_average_pytree", "systematic_offsets"]


def systematic_offsets(generator: torch.Generator, m: int, k: int) -> torch.Tensor:
    """Per-node class offset o_j ~ U[0, k)."""
    return torch.randint(0, k, (m,), generator=generator, device=generator.device)


def _leaf_average(
    leaf: torch.Tensor,     # this rank's rows [r, d1, ...rest] ([m, ...] unsharded)
    offsets: torch.Tensor,  # [m] int
    a: torch.Tensor,        # [m, m] selection, A[j, i] = j in N_i^k
    k: int,
    quantize_bits: int = 0,  # 8 -> int8 payloads (+1 f32 scale per message)
    loc=None,               # sharding.Local: the receivers and the mesh (None: unsharded)
    red_axes: Tuple[str, ...] = (),  # the axes the payload's pieces are spread over
) -> torch.Tensor:
    r = leaf.shape[0]
    loc = shd.local_view(None, leaf) if loc is None else loc
    rows = loc.rows()

    def gather(x):  # every sender's piece, over node
        return shd.all_gather(x, loc.mesh, "node", use="exchange")

    if leaf.dim() == 1:  # [m] scalars-per-node: gossip densely (negligible)
        sel = a[:, rows].float()
        cnt = sel.sum(dim=0)
        agg = torch.einsum("j,ji->i", gather(leaf).float(), sel)
        return torch.where(cnt > 0, agg / cnt.clamp(min=1.0), leaf).to(leaf.dtype)
    d1, rest = leaf.shape[1], tuple(leaf.shape[2:])
    kk = min(k, d1)
    pad = (-d1) % kk
    x = leaf
    if pad:
        x = torch.cat([x, x.new_zeros((r, pad) + rest)], dim=1)
    b1 = (d1 + pad) // kk
    classes = x.reshape((r, kk, b1) + rest)
    off = offsets.to(leaf.device).long().clamp(max=kk - 1)
    payload = classes[torch.arange(r, device=leaf.device), off[rows]]  # [r, b1, *rest]
    if quantize_bits == 8:
        # int8 wire: per-sender absmax scale (one f32 per message), over the
        # whole payload (its pieces' maxima reduced over their ranks)
        pf = payload.float()
        scale = pf.abs().amax(dim=tuple(range(1, pf.dim())), keepdim=True)
        shd.all_reduce(scale, loc.mesh, red_axes, op="max", use="exchange")
        scale = scale.clamp(min=1e-12)
        q = torch.clamp(torch.round(pf / scale * 127.0), -127, 127).to(torch.int8)
        del pf
        q, scale = gather(q), gather(scale)
        payload = (q.float() * scale / 127.0).to(leaf.dtype)
        del q
    else:
        payload = gather(payload)  # [m, b1, *rest]: every sender's piece
    m = payload.shape[0]

    onehot = torch.nn.functional.one_hot(off, kk).to(leaf.dtype)  # [m, kk]
    af = a.to(leaf.dtype)[:, rows]
    # every (receiver, class) pair at once: the class one-hot folded into the
    # selection ([m, r, kk]) and ONE contraction over the sender axis; the
    # 0/1 factors are exact in any float type, the sum runs in f32
    sel = (af[:, :, None] * onehot[:, None, :]).float()          # [j, i, c]
    agg = torch.einsum("jb,jic->icb", payload.reshape(m, -1).float(), sel)
    del payload
    cnt = torch.einsum("ji,jc->ic", af.float(), onehot.float())  # [i, c]
    cnt_b = cnt.reshape((r, kk, 1) + (1,) * len(rest))
    agg = agg.reshape((r, kk, b1) + rest).div_(cnt_b.clamp(min=1.0))
    avg = torch.where(cnt_b > 0, agg.to(leaf.dtype), classes)
    del agg
    out = avg.reshape((r, d1 + pad) + rest)
    return out[:, :d1].contiguous() if pad else out


def _block_axis(whole, spec, k: int) -> int:
    """JAX's block axis: the first trailing axis left whole by the
    placement with at least min(k, 2) entries, else axis 1."""
    spec = tuple(spec) + (None,) * (len(whole) - len(spec))
    for cand in range(1, len(whole)):
        if spec[cand] is None and whole[cand] >= min(k, 2):
            return cand
    return 1


def _piece_leaf(leaf, spec, offsets, a, k, quantize_bits, loc):
    """One leaf of the exchange on this rank's piece [r, ...], blocked
    along JAX's axis (axis 1 unsharded) moved to axis 1."""
    if leaf.dim() == 1:
        return _leaf_average(leaf, offsets, a, k, quantize_bits, loc)
    spec = tuple(spec) + (None,) * (leaf.dim() - len(spec))
    axis = (_block_axis(shd.full_shape(leaf.shape, spec, loc.layout), spec, k)
            if loc.sharded else 1)
    if spec[axis] is not None:
        # no trailing axis left whole: the rows gathered over fsdp and
        # model, averaged whole and cut back to this rank's piece
        full = shd.gather_dims(leaf, spec, loc.mesh, ("fsdp", "model"), use="exchange")
        bare = (spec[0],) + (None,) * (leaf.dim() - 1)
        return loc.cut_trailing(_piece_leaf(full, bare, offsets, a, k, quantize_bits, loc),
                                spec)
    red_axes = tuple(name for e in spec[1:] for name in shd.spec_axes(e))
    if axis == 1:
        return _leaf_average(leaf, offsets, a, k, quantize_bits, loc, red_axes)
    out = _leaf_average(leaf.movedim(axis, 1), offsets, a, k, quantize_bits, loc, red_axes)
    return out.movedim(1, axis).contiguous()


def compressed_pme_average_pytree(
    key: Optional[int],
    params,            # pytree with [m, ...] leaves
    a: torch.Tensor,   # [m, m]
    p: float,
    quantize_bits: int = 0,
    *,
    offsets: Optional[Sequence[torch.Tensor]] = None,  # per-leaf [m] draws
    shardings=None,    # sharding.MeshShardings: params are this rank's pieces
):
    """Drop-in replacement for `pme.pme_average_pytree` (Bernoulli mode):
    leaf idx's offsets are drawn from fold_in(key, idx), or taken from
    `offsets` in JAX leaf order.  With `shardings` the leaves are this
    rank's pieces (see the module's docstring); the offsets are drawn for
    all m nodes, as the unsharded exchange draws them."""
    k = max(2, int(round(1.0 / p)))
    leaves, treedef = tree_flatten(params)
    loc = shd.local_view(shardings, params)
    out = []
    for idx, leaf in enumerate(leaves):
        if offsets is not None:
            off = offsets[idx]
        else:
            off = systematic_offsets(make_generator(fold_in(key, idx), leaf.device), loc.m, k)
        out.append(_piece_leaf(leaf, loc.specs[idx], off, a.to(leaf.device), k, quantize_bits,
                               loc))
    return tree_unflatten(treedef, out)
