"""Launch the CUDA PME average (``csrc/pme_average.cu``).

Replaces ``src/repro/kernels/pme_average/kernel.py::pme_average_pallas``;
see the source for the design and what bounds it.  `pme_average_cuda`
takes CUDA tensors only, checks them, allocates the output and launches on
the current stream.  It takes one lane ([m, n], [m, m]) or L lanes
([L, m, n], [L, m, m]: the lane grid axis JAX's batching rule gives
`pme_average_pallas` under `vmap`), each lane its own m rows, in one
launch.  ``receivers=(r0, r)`` averages for receivers r0 ... r0 + r - 1
alone (all m rows still send): the output is [r, n] ([L, r, n]), what a
rank of a sharded step needs for its own nodes.
``pme_average_cuda.launches`` counts its launches,
``pme_average_cuda.lane_launches`` those with a lane axis and
``pme_average_cuda.range_launches`` those given a receiver range.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, fake_route

# type codes of the C interface
_W_TYPES = {torch.float32: 0, torch.bfloat16: 1}
_MASK_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.bool: 2, torch.uint8: 3}
MAX_NODES = 48 * 1024 // (8 * 4)  # eight A^T rows in 48 KB of shared memory (m, not L·m)
MAX_LANES = 65535  # the lanes one launch takes


@functools.lru_cache(maxsize=None)
def _bind():
    """The C entry point, loaded and typed once, at first use."""
    fn = _build.load("pme_average").pme_average_range
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def pme_average_cuda(
    w: torch.Tensor,      # [m, n] or [L, m, n] float32 or bfloat16
    masks: torch.Tensor,  # w's shape: bool / uint8, or float32 / bfloat16
    a: torch.Tensor,      # [m, m] or [L, m, m] selection, A[sender, receiver]
    receivers: Optional[Tuple[int, int]] = None,  # (r0, r): receivers r0 ... r0 + r - 1
) -> torch.Tensor:
    """out = cnt > 0 ? agg / max(cnt, 1) : w, in w's type (f32 compute),
    lane by lane for [L, m, n] operands; [r, n] rows with `receivers`."""
    if w.dim() not in (2, 3) or masks.shape != w.shape:
        raise ValueError(f"need w and masks of one [m, n] or [L, m, n] shape, got "
                         f"{tuple(w.shape)} and {tuple(masks.shape)}")
    lanes = w.shape[0] if w.dim() == 3 else 1
    m, n = w.shape[-2:]
    r0, r = (0, m) if receivers is None else (int(receivers[0]), int(receivers[1]))
    if not (r >= 1 and r0 >= 0 and r0 + r <= m):
        raise ValueError(f"receivers {receivers} outside the {m} rows")
    fake = fake_route.active()
    if fake:
        fake_route.check(w, masks, a)
    elif not w.is_cuda:
        raise ValueError("pme_average_cuda launches a CUDA kernel: pass CUDA tensors")
    want = (m, m) if w.dim() == 2 else (lanes, m, m)
    if tuple(a.shape) != want:
        raise ValueError(f"selection must be {list(want)}, got {tuple(a.shape)}")
    if not 1 <= lanes <= MAX_LANES:
        raise ValueError(f"pme_average_cuda takes 1 to {MAX_LANES} lanes, got {lanes}")
    if w.dtype not in _W_TYPES or masks.dtype not in _MASK_TYPES:
        raise TypeError(f"unsupported types: w {w.dtype}, masks {masks.dtype}")
    if m > MAX_NODES:
        raise ValueError(f"pme_average_cuda takes at most {MAX_NODES} nodes, got {m}")
    if masks.device != w.device or a.device != w.device:
        raise ValueError("w, masks and a must be on one device")
    if not (w.is_contiguous() and masks.is_contiguous()):
        raise ValueError("w and masks must be contiguous")
    a32 = a if a.dtype == torch.float32 and a.is_contiguous() else a.to(torch.float32).contiguous()
    out = w.new_empty(tuple(w.shape[:-2]) + (r, n))
    if n == 0 or fake:
        return out
    rc = _bind()(
        w.data_ptr(), masks.data_ptr(), a32.data_ptr(), out.data_ptr(), m, n, lanes, r0, r,
        _W_TYPES[w.dtype], _MASK_TYPES[masks.dtype],
        torch.cuda.current_stream(w.device).cuda_stream,
    )
    _build.check(rc, "pme_average")
    pme_average_cuda.launches += 1
    pme_average_cuda.lane_launches += int(w.dim() == 3)
    pme_average_cuda.range_launches += int(receivers is not None)
    return out


pme_average_cuda.launches = 0
pme_average_cuda.lane_launches = 0
pme_average_cuda.range_launches = 0
