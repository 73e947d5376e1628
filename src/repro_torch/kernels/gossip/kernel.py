"""Launch the CUDA gossip contraction (``csrc/gossip_gather.cu``).

Replaces ``src/repro/kernels/gossip/kernel.py::gossip_gather_pallas``; see
the source for the design and what bounds it.  `gossip_gather` takes CUDA
tensors only, checks them, allocates the outputs and launches on the
current stream.  ``gossip_gather.launches`` counts its launches.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from repro_torch.kernels import _build

MAX_TERMS = 8


def _bind():
    lib = _build.load("gossip_gather")
    fn = lib.gossip_gather
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def gossip_gather(
    nbrs: torch.Tensor,              # [m, k] int32
    ws: torch.Tensor,                # [G, m, k] float32, padding already 0.0
    xs: Sequence[torch.Tensor],      # T sender stacks, each [m, n] float32
    term_groups: Tuple[int, ...],    # term t contracts ws[term_groups[t]]
) -> Tuple[torch.Tensor, ...]:
    """out_t[i, l] = sum_slot ws[g_t][i, slot] * xs[t][nbrs[i, slot], l]."""
    m, k = nbrs.shape
    g = ws.shape[0]
    if not nbrs.is_cuda:
        raise ValueError("gossip_gather launches a CUDA kernel: pass CUDA tensors")
    if nbrs.dtype != torch.int32 or ws.dtype != torch.float32:
        raise TypeError("gossip_gather needs int32 nbrs and float32 weights")
    if tuple(ws.shape) != (g, m, k) or not (1 <= len(xs) <= MAX_TERMS):
        raise ValueError(f"bad shapes: nbrs {tuple(nbrs.shape)}, ws "
                         f"{tuple(ws.shape)}, {len(xs)} terms (1..{MAX_TERMS})")
    if len(term_groups) != len(xs) or not all(0 <= t < g for t in term_groups):
        raise ValueError(f"term_groups {term_groups} do not index {g} tables")
    if (1 + g) * k * 4 > 48 * 1024:
        raise ValueError(f"neighbour table too wide for the kernel: k={k}")
    n = xs[0].shape[1]
    for x in xs:
        if x.dtype != torch.float32 or x.shape != (m, n) or not x.is_contiguous():
            raise ValueError("every operand must be a contiguous float32 [m, n]")
        if x.device != nbrs.device:
            raise ValueError("operands and neighbour table on different devices")
    nbrs, ws = nbrs.contiguous(), ws.contiguous()
    outs = tuple(torch.empty_like(x) for x in xs)
    if n == 0:
        return outs
    fn = _bind()
    t = len(xs)
    rc = fn(
        nbrs.data_ptr(), ws.data_ptr(), g,
        (ctypes.c_void_p * t)(*[x.data_ptr() for x in xs]),
        (ctypes.c_void_p * t)(*[o.data_ptr() for o in outs]),
        (ctypes.c_int * t)(*term_groups), t, m, k, n,
        torch.cuda.current_stream(nbrs.device).cuda_stream,
    )
    _build.check(rc, "gossip_gather")
    gossip_gather.launches += 1
    return outs


gossip_gather.launches = 0
