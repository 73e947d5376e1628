"""Launch the CUDA gossip contraction (``csrc/gossip_gather.cu``).

Replaces ``src/repro/kernels/gossip/kernel.py::gossip_gather_pallas``; see
the source for the design and what bounds it.  `gossip_gather` takes CUDA
tensors only, checks them, allocates the outputs and launches on the
current stream the source's variant for the operands' type (`VARIANTS`:
float32 or bfloat16, one type for all terms of a launch).
``gossip_gather.launches`` counts its launches,
``gossip_gather.variant_launches`` the same launches by variant.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from repro_torch.kernels import _build, fake_route

MAX_TERMS = 8
# operand type -> (variant name, the C entry point's dtype code)
VARIANTS = {torch.float32: ("f32", 0), torch.bfloat16: ("bf16", 1)}


@functools.lru_cache(maxsize=None)
def _bind():
    """The C entry point, loaded and typed once, at first use."""
    lib = _build.load("gossip_gather")
    fn = lib.gossip_gather
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def gossip_gather(
    nbrs: torch.Tensor,              # [m, k] int32
    ws: torch.Tensor,                # [G, m, k] float32, padding already 0.0
    xs: Sequence[torch.Tensor],      # T sender stacks, each [M, n], one type
    term_groups: Tuple[int, ...],    # term t contracts ws[term_groups[t]]
) -> Tuple[torch.Tensor, ...]:
    """out_t[i, l] = sum_slot ws[g_t][i, slot] * xs[t][nbrs[i, slot], l],
    summed in f32 and stored in the operands' type (float32 or bfloat16),
    [m, n] each.  A sender stack may hold more rows than there are
    receivers (M >= m: the replica tables of `mixing.mix_replicated`);
    `nbrs` must index its rows."""
    m, k = nbrs.shape
    g = ws.shape[0]
    fake = fake_route.active()
    if fake:
        fake_route.check(nbrs, ws, *xs)
    elif not nbrs.is_cuda:
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
    dtype = xs[0].dtype
    if dtype not in VARIANTS:
        raise TypeError(f"unsupported operand type {dtype}; the kernel takes "
                        f"{', '.join(map(str, VARIANTS))}")
    for x in xs:
        if x.dtype != dtype:
            raise TypeError(f"all terms of a launch share one type: {dtype} and {x.dtype}")
        if x.dim() != 2 or x.shape[0] < m or x.shape[1] != n or not x.is_contiguous():
            raise ValueError("every operand must be a contiguous [M, n] with M >= m")
        if x.device != nbrs.device:
            raise ValueError("operands and neighbour table on different devices")
    nbrs, ws = nbrs.contiguous(), ws.contiguous()
    outs = tuple(torch.empty((m, n), dtype=x.dtype, device=x.device) for x in xs)
    if n == 0 or fake:
        return outs
    fn = _bind()
    variant, code = VARIANTS[dtype]
    t = len(xs)
    rc = fn(
        nbrs.data_ptr(), ws.data_ptr(), g,
        (ctypes.c_void_p * t)(*[x.data_ptr() for x in xs]),
        (ctypes.c_void_p * t)(*[o.data_ptr() for o in outs]),
        (ctypes.c_int * t)(*term_groups), t, m, k, n, code,
        torch.cuda.current_stream(nbrs.device).cuda_stream,
    )
    _build.check(rc, f"gossip_gather ({variant})")
    gossip_gather.launches += 1
    gossip_gather.variant_launches[variant] += 1
    return outs


gossip_gather.launches = 0
gossip_gather.variant_launches = {name: 0 for name, _ in VARIANTS.values()}
