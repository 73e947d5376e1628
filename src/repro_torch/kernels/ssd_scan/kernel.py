"""Launch the CUDA SSD intra-chunk contraction (``csrc/ssd_intra_chunk.cu``).

Replaces ``src/repro/kernels/ssd_scan/kernel.py::ssd_intra_chunk_pallas``;
see the source for the design and what bounds it.  `ssd_intra_chunk_cuda`
takes CUDA tensors only, checks them, allocates the outputs and launches on
the current stream one of the source's two variants, which `ssd_variant`
picks from the type and shape alone.  ``ssd_intra_chunk_cuda.launches``
counts its launches, ``ssd_intra_chunk_cuda.variant_launches`` the same
launches by variant.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build, fake_route

_TYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK = 128
MAX_SMEM = 232448  # an H100 block's dynamic shared memory limit, bytes
VARIANTS = {"cuda_cores": 0, "tensor_cores": 1}  # the C entry point's codes


def smem_bytes(l: int, p: int, n: int) -> int:
    """Shared memory one block of the cuda_cores variant takes (B and C
    transposed with a padded row where it fits, x, W, dt, cum and the
    decay, all f32)."""
    lp = -(-l // 4) * 4
    rest = lp * p + lp * lp + 3 * lp
    sl = lp + 4 if (lp // 4) % 2 == 0 else lp
    if 4 * (2 * n * sl + rest) > MAX_SMEM:
        sl = lp
    return 4 * (2 * n * sl + rest)


# the tensor-core layout's constants (``tc::`` in the source)
_TC_PANEL = 128 * 128            # a 64-column panel of a 128-row chunk tile, bf16
_TC_S = 64 * 64 * 4 + 64 * 128 * 4  # S = C B^T of both row tiles, f32
_TC_OUT = 2 * 64 * 128           # a consumer warpgroup's staging buffer
_TC_VEC = 3 * 128 * 4            # one head's cum, dt and decay, f32
_TC_CONSUMERS = 3                # consumer warpgroups of a block


def tc_smem_bytes(l: int, p: int, n: int) -> int:
    """Shared memory one block of the tensor_cores variant takes
    (``tc::choose_layout`` in the source): B of the work item as 64-column
    panels of 128 rows, C and then S over it (the larger of the two), a ring
    of x tiles, a staging buffer and two heads' vectors for each of the
    three consumer warpgroups, the barriers, and 1024 bytes to align the
    tiles; the most x stages (up to four) that fit.  Where none fits, one
    stage's bytes (above the limit).  L does not enter: every chunk tile
    has 128 rows, those past L zero."""
    npan, xpan = -(-n // 64), -(-p // 64)
    for stages in (4, 3, 2, 1):
        bytes_ = (1024 + npan * _TC_PANEL + max(npan * _TC_PANEL, _TC_S)
                  + stages * xpan * _TC_PANEL + _TC_CONSUMERS * (_TC_OUT + 2 * _TC_VEC)
                  + 16 * stages + 24)
        if bytes_ <= MAX_SMEM:
            break
    return bytes_


def ssd_variant(dtype: torch.dtype, l: int, p: int, n: int) -> str:
    """The variant a call of this type and chunk shape launches: bf16 with
    L and P multiples of 16 up to 128 and N a multiple of 16 takes the
    tensor cores; f32, and bf16 with L <= 128 and P, N multiples of 4, the
    CUDA cores; anything else (or a chunk that fits no block's shared
    memory) raises."""
    if dtype not in _TYPES:
        raise TypeError(f"unsupported type {dtype}; the kernel takes {tuple(_TYPES)}")
    if (dtype == torch.bfloat16 and l % 16 == 0 and p % 16 == 0 and n % 16 == 0
            and l <= MAX_CHUNK and p <= 128 and tc_smem_bytes(l, p, n) <= MAX_SMEM):
        return "tensor_cores"
    if l > MAX_CHUNK or p % 4 or n % 4:
        raise ValueError(f"the kernel takes L <= {MAX_CHUNK} and P, N multiples of 4; "
                         f"got L={l}, P={p}, N={n}")
    if smem_bytes(l, p, n) > MAX_SMEM:
        raise ValueError(f"a chunk of L={l}, P={p}, N={n} needs {smem_bytes(l, p, n)} "
                         f"bytes of shared memory, above the card's {MAX_SMEM}")
    return "cuda_cores"


def _bind():
    fn = _build.load("ssd_intra_chunk").ssd_intra_chunk
    # xc, dtc, cum, bc, cc, y, state; B, Nc, L, H, P, G, N; dtype; variant; stream
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ssd_intra_chunk_cuda(
    xc: torch.Tensor,   # [B, Nc, L, H, P]
    dtc: torch.Tensor,  # [B, Nc, L, H] f32
    cum: torch.Tensor,  # [B, Nc, L, H] f32
    bc: torch.Tensor,   # [B, Nc, L, G, N]
    cc: torch.Tensor,   # [B, Nc, L, G, N]
    rep: int,           # heads per group, H = G * rep
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y [B,Nc,L,H,P] in xc's type, state [B,Nc,H,P,N] f32)."""
    fake = fake_route.active()
    if fake:
        fake_route.check(xc, dtc, cum, bc, cc)
    elif not xc.is_cuda:
        raise ValueError("ssd_intra_chunk_cuda launches a CUDA kernel: pass CUDA tensors")
    if xc.dim() != 5 or bc.dim() != 5 or cc.shape != bc.shape:
        raise ValueError(f"need xc [B,Nc,L,H,P] and bc, cc [B,Nc,L,G,N], got "
                         f"{tuple(xc.shape)}, {tuple(bc.shape)}, {tuple(cc.shape)}")
    b, nc, l, h, p = xc.shape
    g, n = bc.shape[3], bc.shape[4]
    if bc.shape[:3] != xc.shape[:3] or dtc.shape != xc.shape[:4] or cum.shape != dtc.shape:
        raise ValueError("xc, dtc, cum, bc and cc disagree on [B, Nc, L(, H)]")
    if g * rep != h:
        raise ValueError(f"H = {h} heads must be G = {g} groups x rep = {rep}")
    if bc.dtype != xc.dtype or cc.dtype != xc.dtype:
        raise TypeError(f"unsupported types: xc {xc.dtype}, bc {bc.dtype}, cc {cc.dtype}")
    variant = ssd_variant(xc.dtype, l, p, n)
    if dtc.dtype != torch.float32 or cum.dtype != torch.float32:
        raise TypeError("dtc and cum must be float32")
    if any(t.device != xc.device for t in (dtc, cum, bc, cc)):
        raise ValueError("all inputs must be on one device")
    xc, dtc, cum, bc, cc = (t.contiguous() for t in (xc, dtc, cum, bc, cc))
    y = torch.empty_like(xc)
    state = torch.empty((b, nc, h, p, n), dtype=torch.float32, device=xc.device)
    if xc.numel() == 0 or fake:
        return y, state
    rc = _bind()(
        xc.data_ptr(), dtc.data_ptr(), cum.data_ptr(), bc.data_ptr(), cc.data_ptr(),
        y.data_ptr(), state.data_ptr(), b, nc, l, h, p, g, n, _TYPES[xc.dtype],
        VARIANTS[variant], torch.cuda.current_stream(xc.device).cuda_stream,
    )
    _build.check(rc, f"ssd_intra_chunk ({variant})")
    ssd_intra_chunk_cuda.launches += 1
    ssd_intra_chunk_cuda.variant_launches[variant] += 1
    return y, state


ssd_intra_chunk_cuda.launches = 0
ssd_intra_chunk_cuda.variant_launches = dict.fromkeys(VARIANTS, 0)
