"""`gather_terms`-shaped entry point for the CUDA gossip kernel.

Keeps the contract of ``src/repro/kernels/gossip/ops.py``:

  * dead-slot masking: structural padding slots (`pad`) get weight exactly
    0.0 before the kernel runs, so poisoned padding weights (NaN, garbage)
    never reach a receiver row;
  * weight-table deduplication: terms passing the *same* weight tensor
    (PME's payload and count walks share one selection table) are found by
    object identity and share one table in the launch;
  * leaf reshaping: [m, ...] operands are flattened to [m, n] and terms are
    bucketed by trailing size, one launch per distinct n.

The device of the tensors decides: CPU tensors take the plain version
(`ref.gather_terms_ref`), CUDA tensors launch the kernel or raise.  There
is no fallback from the card to the plain version.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels.gossip.kernel import gossip_gather
from repro_torch.kernels.gossip.ref import gather_terms_ref


def gather_terms_kernel(
    nbrs: torch.Tensor,                                   # [m, k] padded table
    terms: Sequence[Tuple[torch.Tensor, torch.Tensor]],   # ([m, k] w, [m, ...] x)
    *,
    pad: Optional[torch.Tensor] = None,                   # [m, k] padding slots
) -> Tuple[torch.Tensor, ...]:
    """out_t[i] = sum_slot w_t[i, slot] * x_t[nbrs[i, slot]] for every term."""
    if not nbrs.is_cuda:
        return gather_terms_ref(nbrs, terms, pad=pad)
    m = nbrs.shape[0]
    nbrs32 = nbrs.to(torch.int32)

    masked: dict = {}

    def mask_w(w: torch.Tensor) -> torch.Tensor:
        if id(w) not in masked:
            wf = w.to(torch.float32)
            masked[id(w)] = (
                torch.where(pad, torch.zeros_like(wf), wf) if pad is not None else wf
            )
        return masked[id(w)]

    buckets: dict = {}  # n_flat -> (tables, index by id, entries)
    for t, (w, x) in enumerate(terms):
        n_flat = math.prod(x.shape[1:])
        tables, by_id, entries = buckets.setdefault(n_flat, ([], {}, []))
        if id(w) not in by_id:
            by_id[id(w)] = len(tables)
            tables.append(mask_w(w))
        entries.append((t, by_id[id(w)], x))

    outs: list = [None] * len(terms)
    for n_flat, (tables, _, entries) in buckets.items():
        xs = [x.reshape(m, n_flat).contiguous() for _, _, x in entries]
        res = gossip_gather(
            nbrs32, torch.stack(tables), xs, tuple(g for _, g, _ in entries)
        )
        for (t, _, x), out in zip(entries, res):
            outs[t] = out.reshape(x.shape)
    return tuple(outs)
