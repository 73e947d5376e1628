"""The kernels' route on fake tensors, for the dry run's memory trace.

The dry run traces a step on fake tensors (`FakeTensorMode`: shapes and
types, no storage) on the CPU, where every wrapper would take its plain
version.  The plain versions make transients the kernels never make (the
plain attention's [S, S] f32 scores), so a trace of them does not give the
card's peak.  Inside `kernel_route()` each wrapper takes its kernel's
route instead: it checks its operands and allocates its outputs and
temporaries as the launch on the card would, then skips the launch.
Nothing is built, nothing is launched and no launch is counted.  The route
raises on any operand that is not a fake tensor, so a real tensor can
never take it and come back with uninitialised memory.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

__all__ = ["kernel_route", "active", "check"]

_ACTIVE = contextvars.ContextVar("repro_torch_kernel_route", default=False)


@contextlib.contextmanager
def kernel_route():
    """Every kernel wrapper takes its kernel's route on fake tensors while
    the block runs."""
    token = _ACTIVE.set(True)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active() -> bool:
    return _ACTIVE.get()


def check(*tensors: torch.Tensor) -> None:
    """Raise unless every operand is a fake tensor."""
    from torch._subclasses.fake_tensor import FakeTensor

    for t in tensors:
        if isinstance(t, torch.Tensor) and not isinstance(t, FakeTensor):
            raise RuntimeError(
                "the kernel route of the memory trace takes fake tensors only "
                "(FakeTensorMode); a real tensor must launch the kernel"
            )
