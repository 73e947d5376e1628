"""SwiGLU feed-forward block (port of `repro.models.mlp`)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, linear

__all__ = ["mlp_init", "mlp_apply"]


def mlp_init(generator: torch.Generator, d: int, d_ff: int, dtype) -> dict:
    return {
        "w_gate": dense_init(generator, (d, d_ff), dtype),
        "w_up": dense_init(generator, (d, d_ff), dtype),
        "w_down": dense_init(generator, (d_ff, d), dtype),
    }


def mlp_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    return linear(F.silu(linear(x, params["w_gate"])) * linear(x, params["w_up"]),
                  params["w_down"])
