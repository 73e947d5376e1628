"""Functional optimizers (port of `repro.optim`)."""
from repro_torch.optim.optimizers import (  # noqa: F401
    AdamState,
    Optimizer,
    adam,
    apply_updates,
    momentum,
    sgd,
)

__all__ = ["Optimizer", "AdamState", "sgd", "momentum", "adam", "apply_updates"]
