"""The four input shapes and the (arch x shape) policy (port of
`repro.configs.shapes`).

  train_4k     seq=4096    global_batch=256   -> one PaME step
  prefill_32k  seq=32768   global_batch=32    -> prefill
  decode_32k   seq=32768   global_batch=128   -> one decode step (1 new
                                                 token, KV/state cache of seq)
  long_500k    seq=524288  global_batch=1     -> one decode step

long_500k policy, as in JAX: SSM and hybrid archs run natively (O(1)
state); every other arch without a window gets a sliding window of
`LONG_CTX_WINDOW` tokens and a ring cache of that capacity (the hybrid's
shared attention keeps its own window or none).  Full quadratic attention
at 512k tokens is what the window replaces.

`input_specs` returns stand-ins on the ``meta`` device: shapes and types,
nothing allocated, where JAX returns ``jax.ShapeDtypeStruct`` leaves.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import init_cache

__all__ = ["InputShape", "INPUT_SHAPES", "LONG_CTX_WINDOW", "config_for_shape",
           "input_specs", "cache_capacity"]

LONG_CTX_WINDOW = 4096


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def config_for_shape(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Apply the per-shape policy (a sliding window at 512k for every
    non-SSM arch that has none)."""
    if shape.name == "long_500k" and cfg.arch_type != "ssm" and cfg.window is None:
        return cfg.replace(window=LONG_CTX_WINDOW)
    return cfg


def cache_capacity(cfg: ModelConfig, shape: InputShape) -> int:
    """Ring-buffer capacity of the decode caches."""
    if cfg.window is not None:
        return min(shape.seq_len, cfg.window)
    return shape.seq_len


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: InputShape, m_nodes: int = 1) -> Dict[str, object]:
    """Meta-tensor stand-ins for every model input (nothing allocated).

    train:   tokens [m, B/m, S]   (+ per-node patch embeds for vlm)
    prefill: tokens [B, S]        (+ patch embeds)
    decode:  token [B], pos [], the cache tree of `init_cache` (JAX's leaf
             order) at `cache_capacity`
    """
    cfg = config_for_shape(cfg, shape)
    i32 = torch.int32
    dtype = getattr(torch, cfg.dtype)
    text = shape.seq_len - (cfg.n_patches if cfg.arch_type == "vlm" else 0)
    if shape.kind == "train":
        if shape.global_batch % m_nodes:
            raise ValueError(f"global_batch {shape.global_batch} % m={m_nodes}")
        b = shape.global_batch // m_nodes
        specs = {"tokens": _meta((m_nodes, b, text), i32)}
        if cfg.arch_type == "vlm":
            specs["patch_embeds"] = _meta((m_nodes, b, cfg.n_patches, cfg.vision_dim), dtype)
        return specs
    if shape.kind == "prefill":
        b = shape.global_batch
        specs = {"tokens": _meta((b, text), i32)}
        if cfg.arch_type == "vlm":
            specs["patch_embeds"] = _meta((b, cfg.n_patches, cfg.vision_dim), dtype)
        return specs
    if shape.kind == "decode":
        b = shape.global_batch
        return {
            "token": _meta((b,), i32),
            "pos": _meta((), i32),
            "cache": init_cache(cfg, b, cache_capacity(cfg, shape), device="meta"),
        }
    raise ValueError(shape.kind)
