"""Hand-written CUDA kernels for Hopper, one per Pallas kernel ported.

Each follows the JAX package's split: ``kernel.py`` launches the CUDA
source under ``csrc/`` (built at first use by `_build`), ``ref.py`` is the
plain PyTorch version, ``ops.py`` picks by the tensors' device
(`fake_route`: the kernels' route on fake tensors, for the dry run's
memory trace).
"""
import torch


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise when autograd would need a gradient through a forward-only
    kernel: a ctypes launch records no backward, so the gradient would be
    silently wrong (the JAX package's call fails in the same place)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is forward only (no backward, as in the JAX package): "
            "call it under torch.no_grad() / inference_mode() or on inputs "
            "that do not require grad"
        )
