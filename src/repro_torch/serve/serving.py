"""Batched greedy decode against each node's current local model (port of
`repro.serve.serving`).

:class:`ServeLoop` runs prefill + batched greedy decode (`models.prefill` /
`models.decode_step`) against individual nodes' parameters and records
per-node service cost (prefill ms, decode ms, tokens/s).  With
``cfg.use_flash`` / ``cfg.use_ssd_kernel`` the prefill runs the flash
attention and SSD intra-chunk kernels.

With ``shardings=`` (a `repro_torch.sharding.ServingShardings`) a
ServeLoop serves one rank's part of a sharded model: its parameter pieces,
its rows of each drawn batch (the batch's placement over (node, fsdp)), and
the sharded `prefill` / `decode_step`, whose logits are whole over the
vocabulary on every rank of a `model` group, so that each rank's argmax
gives the same tokens.

Tokens accumulate on the device and move to the host once, after the last
step: a per-step host copy would force a device sync per token and inflate
ms/token.  Timing synchronises the card (`torch.cuda.synchronize`) where
JAX calls ``block_until_ready``.  Prefill and decode run under
`torch.inference_mode`, and decode writes the caches in place.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch import sharding as shd
from repro_torch.models import decode_step, prefill
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["decode_greedy", "component_mean_params", "ServeLoop"]


def component_mean_params(params_stacked, comp=None):
    """Per-node component-mean parameter stack ([m, ...] leaves).

    Row i of the result is the mean (in f32, cast back to the leaf's type)
    over the nodes sharing i's connected component: ``comp`` is the [m]
    component-id vector, None = one component = the global average.  The
    consensus-serving failover: each side of a split serves its own
    component's averaged model.
    """
    stacked = [leaf for leaf in tree_leaves(params_stacked) if leaf.dim() >= 1]
    m = stacked[0].shape[0]
    dev = stacked[0].device
    comp = (torch.zeros(m, dtype=torch.long) if comp is None
            else torch.as_tensor(np.asarray(comp), dtype=torch.long)).to(dev)
    n_comp = int(comp.max()) + 1
    onehot = (comp[:, None] == torch.arange(n_comp, device=dev)[None, :]).float()
    counts = torch.clamp(onehot.sum(dim=0), min=1.0)  # [C]

    def one(leaf):
        if leaf.dim() < 1 or leaf.shape[0] != m:
            return leaf  # scalars / unstacked leaves pass through
        flat = leaf.reshape(m, -1).float()
        means = (onehot.t() @ flat) / counts[:, None]  # [C, n]
        return means[comp].reshape(leaf.shape).to(leaf.dtype)

    return tree_map(one, params_stacked)


def decode_greedy(
    dc: Callable,
    params,
    first_tok: torch.Tensor,
    caches,
    prompt_len: int,
    gen: int,
    offset: int = 0,
) -> torch.Tensor:
    """Greedy-decode ``gen - 1`` steps after the prefill token.

    ``dc(params, tok, pos, caches) -> (logits, caches)`` is the decode step
    (sharded or not: it carries its shardings, and its logits are whole);
    ``first_tok`` is the argmax of the prefill logits.  Returns the [B, gen]
    token matrix on the device: the only host transfer is the caller's.
    """
    tok = first_tok
    toks: List[torch.Tensor] = [tok]
    for i in range(gen - 1):
        logits, caches = dc(params, tok, prompt_len + offset + i, caches)
        tok = torch.argmax(logits, -1).to(torch.int32)
        toks.append(tok)
    return torch.stack(toks, dim=1)


class ServeLoop:
    """Per-node batched greedy decode with service-cost accounting.

    One instance per model config.  Prompts are drawn from a private
    ``np.random.default_rng(seed)`` stream, the same stream as the JAX
    package's ``ServeLoop.make_batch``, so both serve identical prompts.
    """

    def __init__(self, cfg, prompt_len: int = 16, gen: int = 8, batch: int = 2,
                 seed: int = 0, device=None, shardings=None):
        if gen < 2:
            raise ValueError("gen must be >= 2 (prefill token + decode)")
        self.cfg = cfg
        self.prompt_len = int(prompt_len)
        self.gen = int(gen)
        self.batch = int(batch)
        # a vlm's patch embeddings sit before the prompt: decode positions
        # start after them, and the caches hold them too
        self.offset = cfg.n_patches if cfg.arch_type == "vlm" else 0
        self.capacity = self.prompt_len + self.gen + self.offset
        self.device = resolve_device(device)
        self.shardings = shardings
        self._rng = np.random.default_rng(seed)

    def _pf(self, params, batch):
        return prefill(params, self.cfg, batch, self.capacity, shardings=self.shardings)

    def _dc(self, params, tok, pos, caches):
        return decode_step(params, self.cfg, tok, pos, caches, shardings=self.shardings)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def make_batch(self) -> dict:
        prompts = self._rng.integers(0, self.cfg.vocab, (self.batch, self.prompt_len))
        batch = {"tokens": torch.as_tensor(prompts.astype(np.int32), device=self.device)}
        if self.cfg.arch_type == "vlm":
            batch["patch_embeds"] = torch.zeros(
                (self.batch, self.cfg.n_patches, self.cfg.vision_dim),
                dtype=getattr(torch, self.cfg.dtype), device=self.device)
        if self.shardings is not None:  # this rank's rows
            mesh = self.shardings.mesh
            layout = shd.mesh_layout(mesh)
            batch = shd.shard_tree(batch, shd.batch_shardings(batch, layout, node_stacked=False),
                                   layout, shd.mesh_coords(mesh))
        return batch

    def serve_node(self, params_node) -> Dict[str, object]:
        """One decode batch against a single node's parameters (this rank's
        pieces under ``shardings``): prefill and
        decode wall-clock, decode tokens/s (batch x decode steps / wall), the
        [batch, gen] tokens (numpy) and whether every prefill and decode
        logit was finite (kept on the device, read with the tokens)."""
        batch = self.make_batch()
        with torch.inference_mode():
            self._sync()
            t0 = time.perf_counter()
            logits, caches = self._pf(params_node, batch)
            tok = torch.argmax(logits, -1).to(torch.int32)
            finite = torch.isfinite(logits).all()
            self._sync()
            t_prefill = time.perf_counter() - t0

            def dc(params, tok, pos, caches):
                nonlocal finite
                logits, caches = self._dc(params, tok, pos, caches)
                finite = finite & torch.isfinite(logits).all()
                return logits, caches

            t0 = time.perf_counter()
            out = decode_greedy(dc, params_node, tok, caches, self.prompt_len, self.gen,
                                self.offset)
            out = out.cpu().numpy()
            t_decode = time.perf_counter() - t0
        n_decoded = self.batch * (self.gen - 1)
        return {
            "prefill_ms": t_prefill * 1e3,
            "decode_ms": t_decode * 1e3,
            "tokens_per_s": n_decoded / max(t_decode, 1e-9),
            "tokens": out,
            "logits_finite": bool(finite),
        }

    def serve_round(self, params_stacked, node_ids: Optional[Sequence[int]] = None,
                    policy: str = "local", comp=None) -> Dict[int, Dict[str, object]]:
        """Serve one decode batch on each requested node's model.

        ``params_stacked`` is the node-stacked tree ([m, ...] leaves).
        ``policy`` picks what each node serves from: ``"local"``, node i's
        own parameters; ``"consensus"``, the mean model of i's connected
        component (``comp``; None = the global average).
        """
        if policy not in ("local", "consensus"):
            raise ValueError(f"unknown serving policy {policy!r} (local | consensus)")
        if policy == "consensus":
            with torch.inference_mode():
                params_stacked = component_mean_params(params_stacked, comp)
        if node_ids is None:
            node_ids = range(tree_leaves(params_stacked)[0].shape[0])
        stats = {}
        for i in node_ids:
            stats[int(i)] = self.serve_node(tree_map(lambda x, _i=i: x[_i], params_stacked))
        return stats
