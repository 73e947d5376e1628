"""Launch the CUDA PME average (``csrc/pme_average.cu``).

Replaces ``src/repro/kernels/pme_average/kernel.py::pme_average_pallas``;
see the source for the design and what bounds it.  `pme_average_cuda`
takes CUDA tensors only, checks them, allocates the output and launches on
the current stream.  ``pme_average_cuda.launches`` counts its launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# type codes of the C interface
_W_TYPES = {torch.float32: 0, torch.bfloat16: 1}
_MASK_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2, torch.bool: 2}
MAX_NODES = 48 * 1024 // (8 * 4)  # eight A^T rows in 48 KB of shared memory


def _bind():
    fn = _build.load("pme_average").pme_average
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def pme_average_cuda(
    w: torch.Tensor,      # [m, n] float32 or bfloat16
    masks: torch.Tensor,  # [m, n] bool / uint8, or float32 / bfloat16
    a: torch.Tensor,      # [m, m] selection, A[sender, receiver]
) -> torch.Tensor:
    """out = cnt > 0 ? agg / max(cnt, 1) : w, in w's type (f32 compute)."""
    if not w.is_cuda:
        raise ValueError("pme_average_cuda launches a CUDA kernel: pass CUDA tensors")
    if w.dim() != 2 or masks.shape != w.shape:
        raise ValueError(f"need w and masks of one [m, n] shape, got "
                         f"{tuple(w.shape)} and {tuple(masks.shape)}")
    m, n = w.shape
    if a.shape != (m, m):
        raise ValueError(f"selection must be [{m}, {m}], got {tuple(a.shape)}")
    if w.dtype not in _W_TYPES or masks.dtype not in _MASK_TYPES:
        raise TypeError(f"unsupported types: w {w.dtype}, masks {masks.dtype}")
    if m > MAX_NODES:
        raise ValueError(f"pme_average_cuda takes at most {MAX_NODES} nodes, got {m}")
    if masks.device != w.device or a.device != w.device:
        raise ValueError("w, masks and a must be on one device")
    if not (w.is_contiguous() and masks.is_contiguous()):
        raise ValueError("w and masks must be contiguous")
    a32 = a.to(torch.float32).contiguous()
    out = torch.empty_like(w)
    if n == 0:
        return out
    rc = _bind()(
        w.data_ptr(), masks.data_ptr(), a32.data_ptr(), out.data_ptr(), m, n,
        _W_TYPES[w.dtype], _MASK_TYPES[masks.dtype],
        torch.cuda.current_stream(w.device).cuda_stream,
    )
    _build.check(rc, "pme_average")
    pme_average_cuda.launches += 1
    return out


pme_average_cuda.launches = 0
