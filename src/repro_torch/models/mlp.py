"""SwiGLU feed-forward block (port of `repro.models.mlp`).

Under a `repro_torch.sharding.Serve` view the block is tensor-parallel over
`model`: ``w_gate`` / ``w_up`` column-parallel on the hidden columns whose
rows of ``w_down`` the rank holds, ``w_down`` row-parallel with its partial
outputs summed over `model` (`layers.row_linear`).  A gate or up piece that
does not cover those columns is gathered over `model` (`Serve.part`).  In
training the input enters the rank's columns through `Serve.enter`."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import sharding as shd
from repro_torch.models.layers import dense_init, linear, row_linear

__all__ = ["mlp_init", "mlp_apply"]

_UNSHARDED = shd.serve_view(None)


def mlp_init(generator: torch.Generator, d: int, d_ff: int, dtype) -> dict:
    return {
        "w_gate": dense_init(generator, (d, d_ff), dtype),
        "w_up": dense_init(generator, (d, d_ff), dtype),
        "w_down": dense_init(generator, (d_ff, d), dtype),
    }


def mlp_apply(params: dict, x: torch.Tensor, sv, d_ff: int, name: str = "mlp") -> torch.Tensor:
    """The block on x [..., d] (``d_ff`` the whole hidden width); with a
    sharded view `sv`, on this rank's pieces (``name`` the block's path in
    its layer); with None, the unsharded view."""
    sv = sv or _UNSHARDED
    lo, hi = sv.span(params["w_down"], 0, d_ff)
    x = x if (lo, hi) == (0, d_ff) else sv.enter(x)
    gate = linear(x, sv.part(params["w_gate"], 1, d_ff, lo, hi, f"{name}/w_gate"))
    up = linear(x, sv.part(params["w_up"], 1, d_ff, lo, hi, f"{name}/w_up"))
    return row_linear(F.silu(gate) * up, params["w_down"], sv, d_ff, lo)
