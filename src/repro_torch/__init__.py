"""PyTorch port of the PaME reproduction (`repro`), for one NVIDIA H100.

The JAX package `repro` stays the reference; this package imports `torch`
and never `jax` or anything of `repro`.  Module names follow the JAX
package's, so each module's counterpart is easy to find:

  core/      topology, PME samplers and averages, gossip contraction,
             the chunked engine, PaME (Algorithm 1) and the registry
  kernels/   hand-written CUDA kernels for the two PaME Pallas kernels,
             each beside its plain PyTorch version
  models/    the dense decoder (stablelm) for the LM trainer
  launch/    the training CLI

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card they raise instead of carrying on on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless asked otherwise.

    Raises when CUDA is asked for (explicitly or by default) and no card is
    present: the port never falls back to the CPU on its own.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (CLI: --device cpu) "
            "to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
