#!/usr/bin/env python3
"""Time two trees of the port on the chip smoke's training runs, and check
whether each repeats itself bit for bit.

    python3 tools/determinism_ab.py OLD_ROOT NEW_ROOT [--rounds R] [--out FILE]

OLD_ROOT and NEW_ROOT are checkouts of the repository (each with its
``chip_smoke.py`` and ``src/``; unpack a commit with ``git archive`` into a
git-ignored directory).  The script runs R rounds of turns (old, new, new,
old), each turn a fresh process that imports that tree alone and runs, on
the card:

  * F3-pame: ``run_pame`` on Example 3's CNN (label skew C = 7, 4 nodes,
    batch 32, the chip smoke's EX3_CFG), F3_STEPS steps;
  * F4-pame: ``run_pame`` on ResNet-20 (Dirichlet 0.3), F4_STEPS steps;
  * I1: the trainer CLI on deepseek-v2-lite-16b at full width and 3 layers
    (PaME sparse, 4 nodes, 4 x 128 tokens a node), 3 steps;
  * H2-L5: ``bind_batched`` with 5 seeds of the CNN grid (PaME sparse),
    H2_STEPS steps;

each twice in a row after a short warm-up run, from the same seed.  A
turn's line gives each run's seconds a step and whether its two runs gave
equal parameters (``torch.equal`` leaf for leaf; for I1 the per-step
losses, and the parameters where the tree's trainer returns its state).
The image sets are synthetic at IMAGES samples (a step's cost does not
depend on their number).  The summary line gives, for each run and tree,
the median over its turns of the seconds a step and new over old.  Prints
the card's name and power limit.  Compare trees only within one run.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

F3_STEPS, F4_STEPS, H2_STEPS, I1_STEPS = 40, 20, 40, 3
WARMUP = 3
IMAGES = 8192


def _sync():
    import torch

    torch.cuda.synchronize()


def _timed(run, steps):
    """(seconds a step, the run's result) of one run."""
    _sync()
    t0 = time.perf_counter()
    out = run(steps)
    _sync()
    return (time.perf_counter() - t0) / steps, out


def _equal(a, b) -> bool:
    import torch
    from repro_torch.tree import tree_leaves

    xs, ys = tree_leaves(a), tree_leaves(b)
    return len(xs) == len(ys) and all(torch.equal(x, y) for x, y in zip(xs, ys))


def child(root: str) -> dict:
    """One turn: every run of the module docstring in the tree at `root`."""
    sys.path[:0] = [root, os.path.join(root, "src")]
    import inspect

    import torch
    import chip_smoke as cs
    from repro_torch.core import PaMEConfig, build_topology, run_pame
    from repro_torch.core import algorithms as ALG
    from repro_torch.data import dirichlet_partition, label_skew_partition
    from repro_torch.kernels import _build
    from repro_torch.launch import train
    from repro_torch.models.cnn import cnn_apply, cnn_init, resnet20_apply, resnet20_init
    from repro_torch.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    dev = torch.device("cuda")
    topo = build_topology("complete", cs.M)
    cfg = PaMEConfig(**cs.EX3_CFG)
    f3_ds = cs.images(dict(cs.FMNIST, n=IMAGES))
    f4_ds = cs.images(dict(cs.CIFAR, n=IMAGES))

    def f3(k):
        task = cs.vision_task(dev, f3_ds, lambda y: label_skew_partition(y, cs.M, 7, seed=0),
                              cnn_apply)
        return run_pame(0, cnn_init(1, device=dev), cs.M, task["grad_fn"], task["batch_fn"],
                        topo, cfg, num_steps=k, tol_std=0.0, chunk_size=k, device=dev)[0].params

    def f4(k):
        task = cs.vision_task(dev, f4_ds, lambda y: dirichlet_partition(y, cs.M, 0.3, seed=0),
                              resnet20_apply)
        return run_pame(0, resnet20_init(1, device=dev), cs.M, task["grad_fn"],
                        task["batch_fn"], topo, cfg, num_steps=k, tol_std=0.0, chunk_size=k,
                        device=dev)[0].params

    def h2(k):
        task = cs.vision_task(dev, f3_ds, lambda y: label_skew_partition(y, cs.M, 7, seed=0),
                              cnn_apply)
        ba = ALG.get_algorithm("pame").bind_batched(
            task["grad_fn"], topo, [ALG.PaMEHp(**cs.EX3_CFG)], seeds=range(5), mixing="sparse",
            device=dev)
        return ba.params_of(ba.run(cnn_init(1, device=dev), cs.M, task["batch_fn"], k,
                                   chunk_size=k)[0])

    takes_state = "return_state" in inspect.signature(train.main).parameters
    i1_argv = ["--arch", "deepseek-v2-lite-16b", "--variant", "full", "--algo", "pame",
               "--nodes", str(cs.M), "--batch", "4", "--seq", "128", "--layers", "3",
               "--steps", str(I1_STEPS), "--chunk", "1", "--device", "cuda"]

    def i1():
        out = (train.main(i1_argv, return_state=True) if takes_state
               else train.main(i1_argv))
        # the parameters on the host: the second run needs the card
        params = ([x.detach().cpu() for x in tree_leaves(out["state"].params)]
                  if takes_state else None)
        steps = out["seconds"][1:] or out["seconds"]
        return statistics.median(steps), out["loss"], params

    row = {"root": root, "device": torch.cuda.get_device_name(0)}
    for name, run, k in (("F3-pame", f3, F3_STEPS), ("F4-pame", f4, F4_STEPS),
                         ("H2-L5", h2, H2_STEPS)):
        run(WARMUP)
        (t1, a), (t2, b) = _timed(run, k), _timed(run, k)
        row[name] = {"s_per_step": [t1, t2], "steps": k, "equal": _equal(a, b)}
        del a, b
        torch.cuda.empty_cache()
    (t1, l1, p1), (t2, l2, p2) = i1(), i1()
    row["I1"] = {"s_per_step": [t1, t2], "steps": I1_STEPS, "loss_equal": l1 == l2,
                 "equal": None if p1 is None else all(torch.equal(x, y)
                                                      for x, y in zip(p1, p2))}
    return row


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--out", default=None, help="also write every turn's line here (JSON)")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child)), flush=True)
        return
    import torch

    if len(args.roots) != 2 or not torch.cuda.is_available():
        sys.exit(__doc__)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    old, new = (os.path.abspath(r) for r in args.roots)
    turns = []
    for _ in range(args.rounds):
        for tree, root in (("old", old), ("new", new), ("new", new), ("old", old)):
            res = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root],
                                 capture_output=True, text=True, cwd=root)
            if res.returncode != 0:
                sys.exit(f"the {tree} turn failed:\n{res.stderr[-4000:]}")
            row = json.loads(res.stdout.strip().splitlines()[-1])
            row["tree"] = tree
            turns.append(row)
            print(json.dumps(row), flush=True)
    summary = {"gpu": smi, "turns": len(turns)}
    for name in ("F3-pame", "F4-pame", "I1", "H2-L5"):
        med = {tree: statistics.median(t for r in turns if r["tree"] == tree
                                       for t in r[name]["s_per_step"]) for tree in ("old", "new")}
        summary[name] = {"old_s_per_step": med["old"], "new_s_per_step": med["new"],
                         "new_over_old": med["new"] / med["old"],
                         "old_repeats": [r[name]["equal"] for r in turns if r["tree"] == "old"],
                         "new_repeats": [r[name]["equal"] for r in turns if r["tree"] == "new"]}
        if name == "I1":
            summary[name]["old_losses_repeat"] = [r[name]["loss_equal"] for r in turns
                                                  if r["tree"] == "old"]
    print(json.dumps(summary), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"turns": turns, "summary": summary}, f, indent=1)


if __name__ == "__main__":
    main()
