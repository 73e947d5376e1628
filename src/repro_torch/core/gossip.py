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
draws; across rounds every coordinate is exchanged at the same rate.  The
JAX module also pins each payload's sharding over a device mesh; those
arguments have no meaning on one card and are left out.  This exchange
runs no Pallas kernel in JAX: its [m, m] × [m, n/k] contractions are
`torch.einsum` here, in f32 as JAX's ``preferred_element_type`` asks.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core.pme import fold_in, make_generator
from repro_torch.tree import tree_flatten, tree_unflatten

__all__ = ["compressed_pme_average_pytree", "systematic_offsets"]


def systematic_offsets(generator: torch.Generator, m: int, k: int) -> torch.Tensor:
    """Per-node class offset o_j ~ U[0, k)."""
    return torch.randint(0, k, (m,), generator=generator, device=generator.device)


def _leaf_average(
    leaf: torch.Tensor,     # [m, d1, ...rest]
    offsets: torch.Tensor,  # [m] int
    a: torch.Tensor,        # [m, m] selection, A[j, i] = j in N_i^k
    k: int,
    quantize_bits: int = 0,  # 8 -> int8 payloads (+1 f32 scale per message)
) -> torch.Tensor:
    m = leaf.shape[0]
    if leaf.dim() == 1:  # [m] scalars-per-node: gossip densely (negligible)
        sel = a.float()
        cnt = sel.sum(dim=0)
        agg = torch.einsum("j,ji->i", leaf.float(), sel)
        return torch.where(cnt > 0, agg / cnt.clamp(min=1.0), leaf).to(leaf.dtype)
    d1, rest = leaf.shape[1], tuple(leaf.shape[2:])
    kk = min(k, d1)
    pad = (-d1) % kk
    x = leaf
    if pad:
        x = torch.cat([x, x.new_zeros((m, pad) + rest)], dim=1)
    b1 = (d1 + pad) // kk
    classes = x.reshape((m, kk, b1) + rest)
    off = offsets.to(leaf.device).long().clamp(max=kk - 1)
    payload = classes[torch.arange(m, device=leaf.device), off]  # [m, b1, *rest]
    if quantize_bits == 8:
        # int8 wire: per-sender absmax scale (one f32 per message)
        pf = payload.float()
        scale = pf.abs().amax(dim=tuple(range(1, pf.dim())), keepdim=True).clamp(min=1e-12)
        q = torch.clamp(torch.round(pf / scale * 127.0), -127, 127).to(torch.int8)
        payload = (q.float() * scale / 127.0).to(leaf.dtype)
        del pf, q

    onehot = torch.nn.functional.one_hot(off, kk).to(leaf.dtype)  # [m, kk]
    af = a.to(leaf.dtype)
    # every (receiver, class) pair at once: the class one-hot folded into the
    # selection ([m, m, kk]) and ONE contraction over the sender axis; the
    # 0/1 factors are exact in any float type, the sum runs in f32
    sel = (af[:, :, None] * onehot[:, None, :]).float()          # [j, i, c]
    agg = torch.einsum("jb,jic->icb", payload.reshape(m, -1).float(), sel)
    del payload
    cnt = torch.einsum("ji,jc->ic", af.float(), onehot.float())  # [i, c]
    cnt_b = cnt.reshape((m, kk, 1) + (1,) * len(rest))
    agg = agg.reshape((m, kk, b1) + rest).div_(cnt_b.clamp(min=1.0))
    avg = torch.where(cnt_b > 0, agg.to(leaf.dtype), classes)
    del agg
    out = avg.reshape((m, d1 + pad) + rest)
    return out[:, :d1].contiguous() if pad else out


def compressed_pme_average_pytree(
    key: Optional[int],
    params,            # pytree with [m, ...] leaves
    a: torch.Tensor,   # [m, m]
    p: float,
    quantize_bits: int = 0,
    *,
    offsets: Optional[Sequence[torch.Tensor]] = None,  # per-leaf [m] draws
):
    """Drop-in replacement for `pme.pme_average_pytree` (Bernoulli mode):
    leaf idx's offsets are drawn from fold_in(key, idx), or taken from
    `offsets` in JAX leaf order."""
    k = max(2, int(round(1.0 / p)))
    leaves, treedef = tree_flatten(params)
    out = []
    for idx, leaf in enumerate(leaves):
        if offsets is not None:
            off = offsets[idx]
        else:
            off = systematic_offsets(
                make_generator(fold_in(key, idx), leaf.device), leaf.shape[0], k)
        out.append(_leaf_average(leaf, off, a.to(leaf.device), k, quantize_bits))
    return tree_unflatten(treedef, out)
