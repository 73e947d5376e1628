#!/usr/bin/env python3
"""Per-op memory of one dry-run step run for real on the card.

    PYTHONPATH=src python3 tools/memory_probe.py [--arch stablelm-1.6b]
        [--shape train_4k] [--nodes 4] [--batch 8] [--variant baseline]

Builds the step `repro_torch.launch.dryrun` sizes for the combo (the same
config, variant, batch and node count; random weights from seed 0 and
random tokens), runs it once on the card under a dispatch mode that resets
the peak before every op and reads `max_memory_allocated` after it, and
prints one JSON line a kind of op whose launch held more than 32 MiB
beyond both its inputs and its outputs (a temporary the op's CUDA code
allocates, which a trace on fake tensors cannot see), largest first, then
one line with the number of ops, the most bytes live between ops and the
card's peak.  The dry run's memory trace (`dryrun.CUDA_TEMPS`) accounts
for the temporaries this reports.  Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))

from repro_torch.configs import INPUT_SHAPES  # noqa: E402
from repro_torch.core.pame import PaMEState  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import init_params, prefill  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

THRESHOLD = 32 * 2 ** 20


class Probe(TorchDispatchMode):
    """Each op's bytes held beyond its inputs and outputs."""

    def __init__(self):
        super().__init__()
        self.kinds: dict = {}
        self.ops = 0
        self.live_max = 0
        self.peak = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        out = func(*args, **(kwargs or {}))
        peak = torch.cuda.max_memory_allocated()
        after = torch.cuda.memory_allocated()
        self.ops += 1
        self.live_max = max(self.live_max, after)
        self.peak = max(self.peak, peak)
        hidden = peak - max(before, after)
        if hidden > THRESHOLD:
            shapes = [[list(a.shape), str(a.dtype).replace("torch.", "")]
                      for a in args if isinstance(a, torch.Tensor)]
            key = (str(func), json.dumps(shapes))
            row = self.kinds.setdefault(key, {"op": key[0], "inputs": shapes, "count": 0,
                                              "hidden_bytes": 0, "peak_bytes": 0})
            row["count"] += 1
            row["hidden_bytes"] = max(row["hidden_bytes"], hidden)
            row["peak_bytes"] = max(row["peak_bytes"], peak)
        return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--kind", default=None, choices=["train", "prefill"])
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--variant", default="baseline", choices=list(dryrun.VARIANTS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("memory_probe measures the card: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    _, cfg, shape, kind, exchange = dryrun._resolve(args.arch, args.shape, variant=args.variant,
                                                    kind=args.kind)
    specs = dryrun.step_specs(cfg, shape, kind, args.batch, args.nodes)
    rng = np.random.default_rng(2)
    params = init_params(0, cfg, device=dev)
    if kind == "train":
        stacked = tree_map(
            lambda x: x.unsqueeze(0).expand((args.nodes,) + tuple(x.shape)).contiguous(), params)
        del params
        state = PaMEState(params=stacked, sigma=torch.full((args.nodes,), 5.0, device=dev),
                          step=0, key=0)
        del stacked
        step = dryrun.build_train(cfg, args.nodes, exchange=exchange, device=dev)
        batch = {"tokens": torch.as_tensor(rng.integers(
            0, cfg.vocab, tuple(specs["inputs"]["tokens"].shape)).astype(np.int32), device=dev)}
        fn = lambda: step(state, batch)  # noqa: E731
    elif kind == "prefill":
        batch = {"tokens": torch.as_tensor(rng.integers(
            0, cfg.vocab, tuple(specs["inputs"]["tokens"].shape)).astype(np.int32), device=dev)}
        cap = dryrun.cache_capacity(cfg, shape)
        fn = lambda: prefill(params, cfg, batch, cap)  # noqa: E731
    else:
        raise SystemExit(f"the probe takes train and prefill steps, not {kind}")
    torch.cuda.synchronize()
    probe = Probe()
    with torch.inference_mode(kind != "train"), probe:
        fn()
    torch.cuda.synchronize()
    for row in sorted(probe.kinds.values(), key=lambda r: -r["hidden_bytes"]):
        print(json.dumps(row), flush=True)
    print(json.dumps({"combo": [args.arch, args.shape, kind, args.batch, args.nodes,
                                args.variant],
                      "ops": probe.ops, "live_max_bytes": probe.live_max,
                      "peak_bytes": probe.peak, "card": torch.cuda.get_device_name(0)}),
          flush=True)


if __name__ == "__main__":
    main()
