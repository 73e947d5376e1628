"""Public wrapper of the SSD intra-chunk contraction: the device of the
tensors decides.

CPU tensors take the plain version (`ref.ssd_intra_chunk_ref`); CUDA
tensors launch the kernel or raise (inside the dry run's memory trace,
`repro_torch.kernels.fake_route`, fake tensors take the kernel's route).
There is no fallback from the card to
the plain version, and no gradient: like the JAX package's Pallas kernel,
the kernel is forward only, so the wrapper refuses inputs that require grad.
"""
from __future__ import annotations

from repro_torch.kernels import fake_route, refuse_grad
from repro_torch.kernels.ssd_scan.kernel import ssd_intra_chunk_cuda
from repro_torch.kernels.ssd_scan.ref import ssd_intra_chunk_ref


def ssd_intra_chunk(xc, dtc, cum, bc, cc, rep: int):
    """(y [B,Nc,L,H,P], state [B,Nc,H,P,N] f32); see `ref.ssd_intra_chunk_ref`."""
    refuse_grad("ssd_intra_chunk", xc, dtc, cum, bc, cc)
    if not xc.is_cuda and not fake_route.active():
        return ssd_intra_chunk_ref(xc, dtc, cum, bc, cc, rep)
    return ssd_intra_chunk_cuda(xc, dtc, cum, bc, cc, rep)
