"""Launch the CUDA flash attention (``csrc/flash_attention.cu``).

Replaces ``src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas``;
see the source for the design and what bounds it.  `flash_attention_cuda`
takes CUDA tensors only, checks them, allocates the output and launches on
the current stream one of the source's two variants, which `flash_variant`
picks from the type and head dim alone.  ``flash_attention_cuda.launches``
counts its launches, ``flash_attention_cuda.variant_launches`` the same
launches by variant.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, fake_route

_TYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (8, 16, 32, 64, 128, 256)  # the cuda_cores variant's
TC_HEAD_DIMS = (64, 128)               # the tensor_cores variant's (bf16 only)
VARIANTS = {"cuda_cores": 0, "tensor_cores": 1}  # the C entry point's codes


def tc_smem_bytes(d: int) -> int:
    """Dynamic shared memory of one tensor-core block: two stages of a
    64-key K and V tile in bf16, rows padded by 8 elements
    (``tc::Shape<D>::SMEM`` in the source)."""
    return 2 * 2 * 64 * (d + 8) * 2


def flash_variant(dtype: torch.dtype, d: int) -> str:
    """The variant a call of this type and head dim launches: bf16 with
    D in `TC_HEAD_DIMS` takes the tensor cores, f32 and the other D of
    `HEAD_DIMS` the CUDA cores; anything else raises."""
    if dtype == torch.bfloat16 and d in TC_HEAD_DIMS:
        return "tensor_cores"
    if dtype not in _TYPES:
        raise TypeError(f"unsupported type {dtype}; the kernel takes {tuple(_TYPES)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported; the kernel takes {HEAD_DIMS}")
    return "cuda_cores"


def _bind():
    fn = _build.load("flash_attention").flash_attention
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, S, KV, D]
    v: torch.Tensor,  # [B, S, KV, D]
    window: Optional[int] = None,
) -> torch.Tensor:
    """Causal GQA attention, f32 online softmax, output in q's type."""
    fake = fake_route.active()
    if fake:
        fake_route.check(q, k, v)
    elif not q.is_cuda:
        raise ValueError("flash_attention_cuda launches a CUDA kernel: pass CUDA tensors")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"need q [B,S,H,D] and k, v [B,S,KV,D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    kv = k.shape[2]
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d or h % kv:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"unsupported types: q {q.dtype}, k {k.dtype}, v {v.dtype}")
    variant = flash_variant(q.dtype, d)
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if q.numel() == 0 or fake:
        return out
    rc = _bind()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h, kv, d,
        window or 0, d ** -0.5, _TYPES[q.dtype], VARIANTS[variant],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, f"flash_attention ({variant})")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.variant_launches[variant] += 1
    return out


flash_attention_cuda.launches = 0
flash_attention_cuda.variant_launches = dict.fromkeys(VARIANTS, 0)
