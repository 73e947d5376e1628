"""Decoder assembly (port of `repro.models.model`): every family of the JAX
package, and three paths: `train_loss`, `prefill`, `decode_step`.

A model is a sequence of groups; each group repeats a block pattern:

  dense / vlm / audio : [(attn | mla, mlp)] * L            (one group)
  moe                 : [(attn | mla, mlp)] * first_dense_layers, then
                        [(attn | mla, moe)] * the rest
  ssm                 : [("mamba",)] * L
  hybrid (zamba2)     : [shared_block, mamba * attn_every] per group, plus a
                        shorter last group; the transformer block's weights
                        are shared by all sites (``params["shared_block"]``),
                        its KV cache is per site.

The vlm stand-in prepends projected patch embeddings (``vision_proj``) to
the text and scores the text positions only; audio is the dense trunk
over codec tokens.  Untied models carry an ``lm_head`` [d, vocab].
`train_loss` adds the MoE layers' aux losses to the cross-entropy.  With
``cfg.remat`` each layer of a training pass is checkpointed
(`torch.utils.checkpoint`, non-reentrant): ``"full"`` keeps only the
layer's input, ``"dots"`` also keeps the outputs of the plain matrix
products (``aten.mm`` / ``addmm``) and recomputes the rest, as JAX's
``dots_with_no_batch_dims_saveable``; remat changes peak memory, not a
number.

Parameters keep the JAX package's layer-stacked tree: ``groups[gi]`` holds
``{"{i}_{kind}": block params}`` with every leaf of shape [repeat, ...], so
leaf count, sizes and JAX leaf order match and weights carry across with
`repro_torch.convert`.  Caches mirror JAX's tree the same way: a list of
per-group dicts keyed ``"{i}_{kind}"`` whose `KVCache` / `MLACache` /
`SSMCache` leaves are stacked over repeat (mlp and moe blocks carry none).
The trunk is a Python loop over layers (JAX scans); each leaf is split
with `unbind`, whose backward stacks the gradients once.

`prefill` and `decode_step` take ``shardings=`` (a
`repro_torch.sharding.ServingShardings`): the parameters are this rank's
pieces (`sharding.shard_tree` under ``shardings.params``), the batch its
rows and the caches its rows, whole over `model`.  Each layer's leaves are
gathered over `fsdp` just before the layer runs and dropped after it (the
shared block of a hybrid at each of its sites), and every block runs
tensor-parallel over `model` on the rank's heads, columns and experts
(`models.attention`, `mlp`, `ssm`, `moe`); the embedding is vocab-parallel
and the logits' vocab slices are gathered into the whole [B, vocab] f32
logits on every rank.  Unsharded (``shardings=None``) the same body runs
on `sharding.serve_view(None)`: one rank, every collective the identity.

`train_loss` takes a `sharding.train_view` (``view``; None: the unsharded
view): `params` are then one node's pieces on this rank and `batch` its
rows of the node's batch (split over fsdp).  The layers are gathered and
run as in serving, inside each layer's checkpoint under remat (the
recompute gathers again), with every collective's backward (see
`repro_torch.sharding`); the loss is the rank's rows' token sum over the
node's token count, summed over fsdp, plus the MoE aux losses of the
node's whole batch.  The gradient of the pieces is then the gradient of
the node's loss with respect to them.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import torch
from torch.utils import checkpoint as torch_checkpoint

from repro_torch import resolve_device
from repro_torch import sharding as shd
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (dense_init, embed_init, linear, rms_norm, vocab_embed,
                                      vocab_logits)
from repro_torch.models.mlp import mlp_apply, mlp_init
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

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


def _block_init(gen: torch.Generator, kind: str, cfg: ModelConfig, dtype) -> dict:
    ln = torch.ones((cfg.d_model,), dtype=dtype, device=gen.device)
    if kind == "attn":
        return {"ln": ln, "attn": attn.gqa_init(gen, cfg, dtype)}
    if kind == "mla":
        return {"ln": ln, "attn": attn.mla_init(gen, cfg, dtype)}
    if kind == "mlp":
        return {"ln": ln, "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dtype)}
    if kind == "moe":
        return {"ln": ln, "moe": moe_mod.moe_init(gen, cfg, dtype)}
    if kind == "mamba":
        return {"ln": ln, "mamba": ssm_mod.mamba_init(gen, cfg, dtype)}
    raise ValueError(kind)


def _shared_block_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    ones = lambda: torch.ones((cfg.d_model,), dtype=dtype, device=gen.device)  # noqa: E731
    return {"ln1": ones(), "attn": attn.gqa_init(gen, cfg, dtype),
            "ln2": ones(), "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dtype)}


def _stack(trees: list):
    """Stack a list of identical trees along a new leading axis.  Consumes
    the list: each input leaf is dropped once its stack is made, so the
    peak is the stacked tree plus one leaf's inputs, not two trees."""
    per, treedef = [], None
    while trees:
        leaves, treedef = tree_flatten(trees.pop(0))
        per.append(leaves)
    out = []
    for j in range(len(per[0])):
        out.append(torch.stack([lv[j] for lv in per]))
        for lv in per:
            lv[j] = None
    return tree_unflatten(treedef, out)


def init_params(seed: int, cfg: ModelConfig, device=None) -> dict:
    """Random parameters from `seed` on `device` (default ``cuda``).  The
    numbers differ from JAX's init (other generator); the tree does not."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    params: dict = {
        "embed": embed_init(gen, cfg.vocab, cfg.d_model, dtype),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab), dtype)
    if cfg.arch_type == "vlm":
        params["vision_proj"] = dense_init(gen, (cfg.vision_dim, cfg.d_model), dtype)
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
def _block_cache(kind: str, cfg: ModelConfig, batch: int, capacity: int, dtype, device):
    if kind in ("attn", "shared_block"):
        return attn.init_kv_cache(cfg, batch, capacity, dtype, device)
    if kind == "mla":
        return attn.init_mla_cache(cfg, batch, capacity, dtype, device)
    if kind == "mamba":
        return ssm_mod.init_ssm_cache(cfg, batch, dtype, device)
    return None  # mlp / moe carry no cache


def init_cache(cfg: ModelConfig, batch: int, capacity: int, device=None) -> list:
    """Empty caches in the tree `prefill` returns."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    caches = []
    for grp in layer_groups(cfg):
        entry = {}
        for i, kind in enumerate(grp.pattern):
            one = _block_cache(kind, cfg, batch, capacity, dtype, dev)
            if one is None:
                continue
            entry[f"{i}_{kind}"] = tree_map(
                lambda x, _r=grp.repeat: x[None].repeat((_r,) + (1,) * x.dim()), one)
        caches.append(entry)
    return caches


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------
_UNSHARDED = shd.serve_view(None)


def _shared(shared, sv):
    """The hybrid's shared block at one of its sites: (its leaves gathered
    over fsdp, the view inside it)."""
    return sv.weights(shared, sv.sub("shared_block")), sv.at("shared_block")


def _apply_block_full(kind: str, bp: Optional[dict], shared: Optional[dict],
                      cfg: ModelConfig, x, positions, want_cache: bool, capacity: int,
                      sv=_UNSHARDED):
    """Full sequence (train / prefill).  Returns (x, cache or None, MoE aux
    loss or None)."""
    if kind in ("attn", "mla"):
        apply = attn.gqa_apply if kind == "attn" else attn.mla_apply
        h, cache = apply(bp["attn"], cfg, rms_norm(x, bp["ln"]), positions,
                         return_cache=want_cache, cache_capacity=capacity, sv=sv)
        return x + h, cache, None
    if kind == "mlp":
        return x + mlp_apply(bp["mlp"], rms_norm(x, bp["ln"]), sv, cfg.d_ff), None, None
    if kind == "moe":
        h, aux = moe_mod.moe_apply(bp["moe"], cfg, rms_norm(x, bp["ln"]), sv)
        return x + h, None, aux
    if kind == "mamba":
        h, cache = ssm_mod.mamba_apply(bp["mamba"], cfg, rms_norm(x, bp["ln"]),
                                       return_cache=want_cache, sv=sv)
        return x + h, cache, None
    if kind == "shared_block":
        shared, sv = _shared(shared, sv)
        h, cache = attn.gqa_apply(shared["attn"], cfg, rms_norm(x, shared["ln1"]), positions,
                                  return_cache=want_cache, cache_capacity=capacity, sv=sv)
        x = x + h
        return x + mlp_apply(shared["mlp"], rms_norm(x, shared["ln2"]), sv, cfg.d_ff), cache, None
    raise ValueError(kind)


def _apply_block_decode(kind: str, bp: Optional[dict], shared: Optional[dict],
                        cfg: ModelConfig, x, pos: int, cache, sv=_UNSHARDED):
    if kind in ("attn", "mla"):
        decode = attn.gqa_decode if kind == "attn" else attn.mla_decode
        h, _ = decode(bp["attn"], cfg, rms_norm(x, bp["ln"]), pos, cache, sv=sv)
        return x + h
    if kind == "mlp":
        return x + mlp_apply(bp["mlp"], rms_norm(x, bp["ln"]), sv, cfg.d_ff)
    if kind == "moe":
        return x + moe_mod.moe_apply(bp["moe"], cfg, rms_norm(x, bp["ln"]), sv)[0]
    if kind == "mamba":
        h, _ = ssm_mod.mamba_decode(bp["mamba"], cfg, rms_norm(x, bp["ln"]), cache, sv=sv)
        return x + h
    if kind == "shared_block":
        shared, sv = _shared(shared, sv)
        h, _ = attn.gqa_decode(shared["attn"], cfg, rms_norm(x, shared["ln1"]), pos, cache,
                               sv=sv)
        x = x + h
        return x + mlp_apply(shared["mlp"], rms_norm(x, shared["ln2"]), sv, cfg.d_ff)
    raise ValueError(kind)


# the plain (unbatched) matrix products: what the "dots" remat policy keeps
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (torch_checkpoint.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE)


def _checkpointed(cfg: ModelConfig, fn, *args):
    """``fn(*args)`` checkpointed by ``cfg.remat_policy``: the backward
    recomputes what the forward did not keep."""
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            torch_checkpoint.create_selective_checkpoint_contexts, _dots_policy)
    elif cfg.remat_policy != "full":
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r} (full | dots)")
    return torch_checkpoint.checkpoint(fn, *args, use_reentrant=False, **kw)


def _unbind_layers(tree, repeat: int) -> list:
    """The per-layer trees of a tree stacked over repeat, by one `unbind`
    per leaf (views: an in-place write to a layer's cache reaches the
    stacked tensor)."""
    leaves, treedef = tree_flatten(tree)
    per_leaf = [leaf.unbind(0) for leaf in leaves]
    return [tree_unflatten(treedef, [u[li] for u in per_leaf]) for li in range(repeat)]


def _gathered(lp: dict, gi: int, sv):
    """A layer's tree of group `gi` (this rank's pieces) gathered over fsdp
    just before the layer runs (the tree itself unsharded)."""
    return sv.weights(lp, sv.sub("groups", gi), skip=1)


def _layer_full(x, lp: dict, pattern: Tuple[str, ...], shared: Optional[dict],
                cfg: ModelConfig, positions, want_cache: bool, capacity: int,
                sv=_UNSHARDED, gi: int = 0):
    """One layer's blocks over the full sequence, on its pieces `lp`
    gathered over fsdp first: (x, the moe block's aux loss or None, the
    layer's caches by block key)."""
    lp = _gathered(lp, gi, sv)
    entries, aux = {}, None
    for i, kind in enumerate(pattern):
        key = f"{i}_{kind}"
        x, cache, a = _apply_block_full(kind, lp.get(key), shared, cfg, x, positions,
                                        want_cache, capacity, sv.at(f"groups/{gi}/{key}"))
        if cache is not None:
            entries[key] = cache
        if a is not None:
            aux = a
    return x, aux, entries


def _run_trunk_full(params: dict, cfg: ModelConfig, x, positions, want_cache: bool,
                    capacity: int, sv=_UNSHARDED):
    """Returns (x, caches, aux): aux sums the MoE layers' aux losses (f32)."""
    shared = params.get("shared_block")
    caches_out = []
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    # remat pays off only where autograd keeps activations (not in prefill)
    remat = cfg.remat and not want_cache and torch.is_grad_enabled()
    for gi, (grp, gparams) in enumerate(zip(layer_groups(cfg), params["groups"])):
        stacked = {}
        for li, lp in enumerate(_unbind_layers(gparams, grp.repeat)):
            args = (x, lp, grp.pattern, shared, cfg, positions, want_cache, capacity, sv, gi)
            x, aux, entries = (_checkpointed(cfg, _layer_full, *args) if remat
                               else _layer_full(*args))
            del lp, args
            if aux is not None:
                aux_total = aux_total + aux
            if want_cache and entries:
                # each layer's caches go into the group's stacked buffers at
                # once: the peak is the stacked caches plus one layer's
                if not stacked:
                    stacked = tree_map(
                        lambda c: c.new_empty((grp.repeat,) + tuple(c.shape)), entries)
                for dst, src in zip(tree_leaves(stacked), tree_leaves(entries)):
                    dst[li].copy_(src)
        caches_out.append(stacked)
    return x, caches_out, aux_total


def _run_trunk_decode(params: dict, cfg: ModelConfig, x, pos: int, caches: list,
                      sv=_UNSHARDED):
    shared = params.get("shared_block")
    for gi, (grp, gparams, gcache) in enumerate(zip(layer_groups(cfg), params["groups"],
                                                    caches)):
        for lp, lc in zip(_unbind_layers(gparams, grp.repeat),
                          _unbind_layers(gcache, grp.repeat)):
            lp = _gathered(lp, gi, sv)
            for i, kind in enumerate(grp.pattern):
                key = f"{i}_{kind}"
                x = _apply_block_decode(kind, lp.get(key), shared, cfg, x, pos, lc.get(key),
                                        sv.at(f"groups/{gi}/{key}"))
            del lp
    return x


def _whole(params: dict, name: str, sv) -> torch.Tensor:
    """A top-level leaf gathered over fsdp (the embedding's vocab rows stay
    the rank's slice under a sharded view); in training, a leaf not placed
    over fsdp with its gradient summed over fsdp."""
    return sv.weights(params[name], sv.sub(name))


def _embed_inputs(params: dict, cfg: ModelConfig, batch: dict, sv=_UNSHARDED) -> torch.Tensor:
    """Token embeddings; for vlm, the projected patch embeddings
    (``batch["patch_embeds"]`` [B, n_patches, vision_dim]) before them."""
    x = vocab_embed(_whole(params, "embed", sv), batch["tokens"], sv, cfg.vocab)
    if cfg.arch_type == "vlm":
        vis = linear(batch["patch_embeds"].to(x.dtype), _whole(params, "vision_proj", sv))
        x = torch.cat([vis, x], dim=1)
    return x


def _logits(params: dict, cfg: ModelConfig, x: torch.Tensor, sv=_UNSHARDED) -> torch.Tensor:
    x = rms_norm(x, _whole(params, "final_norm", sv))
    head = _whole(params, "embed", sv).t() if cfg.tie_embeddings else _whole(params, "lm_head", sv)
    return vocab_logits(x, head, sv, cfg.vocab)


# ---------------------------------------------------------------------------
# public paths
# ---------------------------------------------------------------------------
def train_loss(params: dict, cfg: ModelConfig, batch: dict, view=None) -> torch.Tensor:
    """Next-token cross-entropy (+ the MoE aux losses).  batch: tokens [B, S]
    (int; + patch_embeds for vlm); the loss is over the text positions.
    With `view` (a `sharding.train_view`), on this rank's pieces of one
    node's parameters and its rows of the node's batch (see the module's
    docstring); the loss is the node's, on every rank."""
    sv = view or shd.train_view()
    x = _embed_inputs(params, cfg, batch, sv)
    positions = torch.arange(x.shape[1], device=x.device)
    x, _, aux = _run_trunk_full(params, cfg, x, positions, False, x.shape[1], sv)
    logits = _logits(params, cfg, x, sv)
    if cfg.arch_type == "vlm":
        logits = logits[:, cfg.n_patches:]
    tok = batch["tokens"].long()
    pred = logits[:, :-1]
    tgt = tok[:, 1:]
    logz = torch.logsumexp(pred, dim=-1)
    gold = torch.gather(pred, -1, tgt[..., None])[..., 0]
    nll = logz - gold
    if not sv.rows:
        return torch.mean(nll) + aux
    return sv.rows_sum(nll.sum()) / (nll.numel() * sv.pieces) + aux


def prefill(params: dict, cfg: ModelConfig, batch: dict, capacity: int, shardings=None):
    """Returns (last-position logits [B, vocab] f32, caches).  With
    `shardings` (a `sharding.ServingShardings`), `params` are this rank's
    pieces and `batch` its rows; the logits are whole over the vocabulary
    and the caches hold the rank's rows, whole over `model`."""
    sv = shd.serve_view(shardings)
    x = _embed_inputs(params, cfg, batch, sv)
    positions = torch.arange(x.shape[1], device=x.device)
    x, caches, _ = _run_trunk_full(params, cfg, x, positions, True, capacity, sv)
    return _logits(params, cfg, x[:, -1:], sv)[:, 0], caches


def decode_step(params: dict, cfg: ModelConfig, token: torch.Tensor, pos: int, caches: list,
                shardings=None):
    """token [B] int, pos the new token's position (after a vlm's patches)
    -> (logits [B, vocab] f32, caches).  Writes the new cache entries (KV,
    MLA latents, SSM states) into `caches` in place (no copy of the caches
    per token) and returns the same list.  With `shardings`, on this rank's
    pieces and rows, as `prefill`."""
    sv = shd.serve_view(shardings)
    x = vocab_embed(_whole(params, "embed", sv), token, sv, cfg.vocab)[:, None]  # [B, 1, d]
    x = _run_trunk_decode(params, cfg, x, int(pos), caches, sv)
    return _logits(params, cfg, x, sv)[:, 0], caches
