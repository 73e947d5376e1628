"""PyTorch port of the PaME reproduction (`repro`), for one NVIDIA H100.

The JAX package `repro` stays the reference; this package imports `torch`
and never `jax` or anything of `repro`.  Module names follow the JAX
package's, so each module's counterpart is easy to find:

  core/      topology, PME samplers and averages, gossip contraction and
             mixers, compression, the compressed exchange, the chunked
             engine, PaME (Algorithm 1), the five baselines (D-PSGD,
             DFedSAM, CHOCO-SGD, BEER, ANQ-NIDS) and the registry
  kernels/   hand-written CUDA kernels for the four Pallas kernels (PME
             average, gossip, flash attention, SSD intra-chunk), each
             beside its plain PyTorch version
  models/    every decoder family of the JAX package (dense, MoE with MLA,
             ssm, hybrid, the vlm and audio stand-ins) and the paper's CNN
             and ResNet-20: train loss, prefill, decode
  optim/     functional sgd, momentum and adam
  configs/   the ten architectures, full and smoke, and the four input
             shapes (`configs.shapes`)
  serve/     ServeLoop: batched greedy decode against each node's model;
             serve-while-train's events and membership
  launch/    the training and serve-while-train CLIs, the one-card dry run
             and the (node, fsdp, model) layout arithmetic
  sharding   per-leaf placements over a (node, fsdp, model) layout

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
    present: the port never falls back to the CPU on its own.  ``meta``
    allocates nothing (`configs.shapes.input_specs`' stand-ins).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (CLI: --device cpu) "
            "to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu' ('meta' for "
                         f"shapes and types alone)")
    return dev
