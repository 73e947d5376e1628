"""Decoder assembly (port of `repro.models.model`): dense, ssm and hybrid
families, and three paths: `train_loss`, `prefill`, `decode_step`.

A model is a sequence of groups; each group repeats a block pattern:

  dense           : [("attn", "mlp")] * L              (one group)
  ssm             : [("mamba",)] * L
  hybrid (zamba2) : [shared_block, mamba * attn_every] per group, plus a
                    shorter last group; the transformer block's weights are
                    shared by all sites (``params["shared_block"]``), its KV
                    cache is per site.

Parameters keep the JAX package's layer-stacked tree: ``groups[gi]`` holds
``{"{i}_{kind}": block params}`` with every leaf of shape [repeat, ...], so
leaf count, sizes and JAX leaf order match and weights carry across with
`repro_torch.convert`.  Caches mirror JAX's tree the same way: a list of
per-group dicts keyed ``"{i}_{kind}"`` whose `KVCache` / `SSMCache` leaves
are stacked over repeat.  The trunk is a Python loop over layers (JAX
scans); each leaf is split with `unbind`, whose backward stacks the
gradients once.  MoE, MLA, VLM and audio come in later slices.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import embed_init, rms_norm
from repro_torch.models.mlp import mlp_apply, mlp_init
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

__all__ = ["LayerGroup", "layer_groups", "init_params", "init_cache", "train_loss",
           "prefill", "decode_step"]


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


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.arch_type not in ("dense", "ssm", "hybrid") or cfg.use_mla:
        raise NotImplementedError(
            f"arch_type={cfg.arch_type!r}{' with MLA' if cfg.use_mla else ''} "
            "not yet ported to repro_torch (dense, ssm and hybrid only)"
        )
    if cfg.remat:
        raise NotImplementedError("remat not yet ported to repro_torch")
    if not cfg.tie_embeddings:
        raise NotImplementedError("untied embeddings not yet ported to repro_torch")
    if cfg.ssm_split_proj:
        raise NotImplementedError("ssm_split_proj not yet ported to repro_torch")


def _block_init(gen: torch.Generator, kind: str, cfg: ModelConfig, dtype) -> dict:
    ln = torch.ones((cfg.d_model,), dtype=dtype, device=gen.device)
    if kind == "attn":
        return {"ln": ln, "attn": attn.gqa_init(gen, cfg, dtype)}
    if kind == "mlp":
        return {"ln": ln, "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dtype)}
    if kind == "mamba":
        return {"ln": ln, "mamba": ssm_mod.mamba_init(gen, cfg, dtype)}
    raise ValueError(kind)


def _shared_block_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    ones = lambda: torch.ones((cfg.d_model,), dtype=dtype, device=gen.device)  # noqa: E731
    return {"ln1": ones(), "attn": attn.gqa_init(gen, cfg, dtype),
            "ln2": ones(), "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dtype)}


def _stack(trees: list):
    """Stack a list of identical trees along a new leading axis."""
    per = [tree_flatten(t) for t in trees]
    return tree_unflatten(per[0][1], [torch.stack(xs) for xs in zip(*(lv for lv, _ in per))])


def init_params(seed: int, cfg: ModelConfig, device=None) -> dict:
    """Random parameters from `seed` on `device` (default ``cuda``).  The
    numbers differ from JAX's init (other generator); the tree does not."""
    _check_ported(cfg)
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    params: dict = {
        "embed": embed_init(gen, cfg.vocab, cfg.d_model, dtype),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
    }
    if cfg.arch_type == "hybrid":
        params["shared_block"] = _shared_block_init(gen, cfg, dtype)
    params["groups"] = [
        _stack([{f"{i}_{kind}": _block_init(gen, kind, cfg, dtype)
                 for i, kind in enumerate(grp.pattern) if kind != "shared_block"}
                for _ in range(grp.repeat)])
        for grp in layer_groups(cfg)
    ]
    return params


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, capacity: int, device=None) -> list:
    """Empty caches in the tree `prefill` returns."""
    _check_ported(cfg)
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    caches = []
    for grp in layer_groups(cfg):
        entry = {}
        for i, kind in enumerate(grp.pattern):
            if kind in ("attn", "shared_block"):
                one = attn.init_kv_cache(cfg, batch, capacity, dtype, dev)
            elif kind == "mamba":
                one = ssm_mod.init_ssm_cache(cfg, batch, dtype, dev)
            else:
                continue
            entry[f"{i}_{kind}"] = tree_map(
                lambda x, _r=grp.repeat: x[None].repeat((_r,) + (1,) * x.dim()), one)
        caches.append(entry)
    return caches


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------
def _apply_block_full(kind: str, bp: Optional[dict], shared: Optional[dict],
                      cfg: ModelConfig, x, positions, want_cache: bool, capacity: int):
    """Full sequence (train / prefill).  Returns (x, cache or None)."""
    if kind == "attn":
        h, cache = attn.gqa_apply(bp["attn"], cfg, rms_norm(x, bp["ln"]), positions,
                                  return_cache=want_cache, cache_capacity=capacity)
        return x + h, cache
    if kind == "mlp":
        return x + mlp_apply(bp["mlp"], rms_norm(x, bp["ln"])), None
    if kind == "mamba":
        h, cache = ssm_mod.mamba_apply(bp["mamba"], cfg, rms_norm(x, bp["ln"]),
                                       return_cache=want_cache)
        return x + h, cache
    if kind == "shared_block":
        h, cache = attn.gqa_apply(shared["attn"], cfg, rms_norm(x, shared["ln1"]), positions,
                                  return_cache=want_cache, cache_capacity=capacity)
        x = x + h
        return x + mlp_apply(shared["mlp"], rms_norm(x, shared["ln2"])), cache
    raise ValueError(kind)


def _apply_block_decode(kind: str, bp: Optional[dict], shared: Optional[dict],
                        cfg: ModelConfig, x, pos: int, cache):
    if kind == "attn":
        h, _ = attn.gqa_decode(bp["attn"], cfg, rms_norm(x, bp["ln"]), pos, cache)
        return x + h
    if kind == "mlp":
        return x + mlp_apply(bp["mlp"], rms_norm(x, bp["ln"]))
    if kind == "mamba":
        h, _ = ssm_mod.mamba_decode(bp["mamba"], cfg, rms_norm(x, bp["ln"]), cache)
        return x + h
    if kind == "shared_block":
        h, _ = attn.gqa_decode(shared["attn"], cfg, rms_norm(x, shared["ln1"]), pos, cache)
        x = x + h
        return x + mlp_apply(shared["mlp"], rms_norm(x, shared["ln2"]))
    raise ValueError(kind)


def _unbind_layers(tree, repeat: int) -> list:
    """The per-layer trees of a tree stacked over repeat, by one `unbind`
    per leaf (views: an in-place write to a layer's cache reaches the
    stacked tensor)."""
    leaves, treedef = tree_flatten(tree)
    per_leaf = [leaf.unbind(0) for leaf in leaves]
    return [tree_unflatten(treedef, [u[li] for u in per_leaf]) for li in range(repeat)]


def _run_trunk_full(params: dict, cfg: ModelConfig, x, positions, want_cache: bool,
                    capacity: int):
    shared = params.get("shared_block")
    caches_out = []
    for grp, gparams in zip(layer_groups(cfg), params["groups"]):
        layers = _unbind_layers(gparams, grp.repeat)
        ys = []
        for li in range(grp.repeat):
            entries = {}
            for i, kind in enumerate(grp.pattern):
                key = f"{i}_{kind}"
                x, cache = _apply_block_full(kind, layers[li].get(key), shared, cfg, x,
                                             positions, want_cache, capacity)
                if cache is not None:
                    entries[key] = cache
            ys.append(entries)
        caches_out.append(_stack(ys) if want_cache and ys[0] else {})
    return x, caches_out


def _run_trunk_decode(params: dict, cfg: ModelConfig, x, pos: int, caches: list):
    shared = params.get("shared_block")
    for grp, gparams, gcache in zip(layer_groups(cfg), params["groups"], caches):
        for lp, lc in zip(_unbind_layers(gparams, grp.repeat),
                          _unbind_layers(gcache, grp.repeat)):
            for i, kind in enumerate(grp.pattern):
                key = f"{i}_{kind}"
                x = _apply_block_decode(kind, lp.get(key), shared, cfg, x, pos, lc.get(key))
    return x


def _logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"])
    return torch.matmul(x, params["embed"].t()).float()


# ---------------------------------------------------------------------------
# public paths
# ---------------------------------------------------------------------------
def train_loss(params: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Next-token cross-entropy.  batch: tokens [B, S] (int)."""
    _check_ported(cfg)
    tok = batch["tokens"].long()
    x = params["embed"][tok]
    positions = torch.arange(x.shape[1], device=x.device)
    x, _ = _run_trunk_full(params, cfg, x, positions, False, x.shape[1])
    logits = _logits(params, x)
    pred = logits[:, :-1]
    tgt = tok[:, 1:]
    logz = torch.logsumexp(pred, dim=-1)
    gold = torch.gather(pred, -1, tgt[..., None])[..., 0]
    return torch.mean(logz - gold)


def prefill(params: dict, cfg: ModelConfig, batch: dict, capacity: int):
    """Returns (last-position logits [B, vocab] f32, caches)."""
    _check_ported(cfg)
    x = params["embed"][batch["tokens"].long()]
    positions = torch.arange(x.shape[1], device=x.device)
    x, caches = _run_trunk_full(params, cfg, x, positions, True, capacity)
    return _logits(params, x[:, -1:])[:, 0], caches


def decode_step(params: dict, cfg: ModelConfig, token: torch.Tensor, pos: int, caches: list):
    """token [B] int, pos the new token's position -> (logits [B, vocab] f32,
    caches).  Writes the new KV entries and SSM states into `caches` in
    place (no copy of the caches per token) and returns the same list."""
    _check_ported(cfg)
    x = params["embed"][token.long()][:, None]  # [B, 1, d]
    x = _run_trunk_decode(params, cfg, x, int(pos), caches)
    return _logits(params, x)[:, 0], caches
