"""Decoder assembly (port of `repro.models.model`, dense family).

Parameters keep the JAX package's layer-stacked tree: ``groups[0]`` holds
``{"0_attn": {"attn": {wq, wk, wv, wo}, "ln"}, "1_mlp": {"mlp": {w_gate,
w_up, w_down}, "ln"}}`` with every leaf of shape [L, ...], so leaf count,
sizes and JAX leaf order match and weights carry across with
`repro_torch.convert`.  The trunk is a Python loop over the L layers (JAX
scans); each leaf is split with `unbind`, whose backward stacks the L
gradients once.  The other families (MoE, SSM, hybrid, VLM, audio),
prefill and decode come in later slices.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import embed_init, rms_norm
from repro_torch.models.mlp import mlp_apply, mlp_init
from repro_torch.tree import tree_flatten, tree_unflatten

__all__ = ["LayerGroup", "layer_groups", "init_params", "train_loss"]


@dataclasses.dataclass(frozen=True)
class LayerGroup:
    repeat: int
    pattern: Tuple[str, ...]  # block kinds, e.g. ("attn", "mlp")


def layer_groups(cfg: ModelConfig) -> List[LayerGroup]:
    at = cfg.arch_type
    if at in ("dense", "vlm", "audio"):
        kind = "mla" if cfg.use_mla else "attn"
        return [LayerGroup(cfg.n_layers, (kind, "mlp"))]
    if at == "moe":
        kind = "mla" if cfg.use_mla else "attn"
        groups = []
        if cfg.first_dense_layers:
            groups.append(LayerGroup(cfg.first_dense_layers, (kind, "mlp")))
        groups.append(LayerGroup(cfg.n_layers - cfg.first_dense_layers, (kind, "moe")))
        return [g for g in groups if g.repeat > 0]
    if at == "ssm":
        return [LayerGroup(cfg.n_layers, ("mamba",))]
    if at == "hybrid":
        every = cfg.attn_every
        n_full = cfg.n_layers // every
        rem = cfg.n_layers - n_full * every
        groups = []
        if n_full:
            groups.append(LayerGroup(n_full, ("shared_block",) + ("mamba",) * every))
        if rem:
            groups.append(LayerGroup(1, ("shared_block",) + ("mamba",) * rem))
        return groups
    raise ValueError(f"unknown arch_type {at!r}")


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.arch_type != "dense" or cfg.use_mla:
        raise NotImplementedError(
            f"arch_type={cfg.arch_type!r}{' with MLA' if cfg.use_mla else ''} "
            "not yet ported to repro_torch (dense only)"
        )
    if cfg.remat:
        raise NotImplementedError("remat not yet ported to repro_torch")


def _block_init(gen: torch.Generator, kind: str, cfg: ModelConfig, dtype) -> dict:
    ln = torch.ones((cfg.d_model,), dtype=dtype, device=gen.device)
    if kind == "attn":
        return {"ln": ln, "attn": attn.gqa_init(gen, cfg, dtype)}
    return {"ln": ln, "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dtype)}


def init_params(seed: int, cfg: ModelConfig, device=None) -> dict:
    """Random parameters from `seed` on `device` (default ``cuda``).  The
    numbers differ from JAX's init (other generator); the tree does not."""
    _check_dense(cfg)
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    params: dict = {
        "embed": embed_init(gen, cfg.vocab, cfg.d_model, dtype),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        raise NotImplementedError("untied embeddings not yet ported to repro_torch")
    (grp,) = layer_groups(cfg)
    layers = [
        {f"{i}_{kind}": _block_init(gen, kind, cfg, dtype)
         for i, kind in enumerate(grp.pattern)}
        for _ in range(grp.repeat)
    ]
    per_layer = [tree_flatten(layer) for layer in layers]
    treedef = per_layer[0][1]
    stacked = [torch.stack(xs) for xs in zip(*(lv for lv, _ in per_layer))]
    params["groups"] = [tree_unflatten(treedef, stacked)]
    return params


def _block(kind: str, bp: dict, cfg: ModelConfig, x, positions):
    if kind == "attn":
        return x + attn.gqa_apply(bp["attn"], cfg, rms_norm(x, bp["ln"]), positions)
    return x + mlp_apply(bp["mlp"], rms_norm(x, bp["ln"]))


def train_loss(params: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Next-token cross-entropy.  batch: tokens [B, S] (int)."""
    _check_dense(cfg)
    tok = batch["tokens"].long()
    x = params["embed"][tok]
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    (grp,) = layer_groups(cfg)
    leaves, treedef = tree_flatten(params["groups"][0])
    per_leaf = [leaf.unbind(0) for leaf in leaves]
    for li in range(grp.repeat):
        lp = tree_unflatten(treedef, [u[li] for u in per_leaf])
        for i, kind in enumerate(grp.pattern):
            x = _block(kind, lp[f"{i}_{kind}"], cfg, x, positions)
    x = rms_norm(x, params["final_norm"])
    logits = torch.matmul(x, params["embed"].t()).float()
    pred = logits[:, :-1]
    tgt = tok[:, 1:]
    logz = torch.logsumexp(pred, dim=-1)
    gold = torch.gather(pred, -1, tgt[..., None])[..., 0]
    return torch.mean(logz - gold)
