#!/usr/bin/env python3
"""The dry run's sharded train step of one arch at train_4k, at two layouts.

    PYTHONPATH=src python3 tools/train_collectives.py --arch stablelm-1.6b \
        [--devices 8] [--device-bytes 85017493504] [--out train.json]

For the arch at its real shape and batch (train_4k, global batch 256, remat
on, m = the layout's node count unless said), runs `dryrun.sharded_collectives` at the
layout the dry run gives ``--devices`` cards with a model axis of 1 (the
train column of the dry-run table) and at (1, 1, devices), a model axis of
``--devices`` with the dry run's default 4 nodes on every card: rank 0's
collective bytes by kind and by use, its calls and its traced peak
(``per_device_memory``), on fake tensors under torch's fake process group.
Nothing is allocated on a card; ``--device-bytes`` sets the layout's
parameter budget (half of it), as the dry run's CLI does.  Prints one JSON line a layout and writes them all to
``--out``.  A full-size trace takes minutes of host time: run it where the
host may take it, one process an arch.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))

from repro_torch.configs.shapes import INPUT_SHAPES  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import logical_layout  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--device-bytes", type=float, default=85017493504.0)
    ap.add_argument("--size", default="full", choices=["full", "smoke"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    base, cfg, shape, _, _ = dryrun._resolve(args.arch, "train_4k", size=args.size)
    layouts = {  # name: (layout, nodes)
        "model_axis_1": (logical_layout(base, args.devices, model_axis=1,
                                        param_budget=args.device_bytes / 2), None),
        f"1/1/{args.devices}": ({"node": 1, "fsdp": 1, "model": args.devices}, 4),
    }
    out = {}
    for name, (layout, m) in layouts.items():
        t0 = time.perf_counter()
        rec = dryrun.sharded_collectives(cfg, shape, layout, shape.global_batch, m=m)
        out[name] = dict(rec, arch=args.arch, layout=dict(layout, devices=args.devices),
                         global_batch=shape.global_batch, trace_s=time.perf_counter() - t0)
        print(json.dumps(out[name]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f)
    return out


if __name__ == "__main__":
    main()
