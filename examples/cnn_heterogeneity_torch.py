"""Paper Example 3 on the PyTorch port: DFL image classification under
label-skew heterogeneity (C classes per node), PaME vs D-PSGD.

    PYTHONPATH=src python examples/cnn_heterogeneity_torch.py --classes 7
    PYTHONPATH=src python examples/cnn_heterogeneity_torch.py --device cpu --steps 4

The port of ``examples/cnn_heterogeneity.py``, with its flags and
``--device`` (default ``cuda``; raises when no card is present).  PaME runs
through `run_pame` (dense exchange: on the card the PME-average kernel
takes ``fc1``); D-PSGD mixes through the sparse `Mixer`, the same B·W as
the dense matrix, which on the card goes through the gossip kernel.
"""
import argparse

import torch

from repro_torch import resolve_device
from repro_torch.core import PaMEConfig, build_topology, make_mixer, run_pame
from repro_torch.core import baselines as B
from repro_torch.data import NodeBatcher, SyntheticClassification, label_skew_partition
from repro_torch.models.cnn import ce_loss, cnn_apply, cnn_init
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten


def grad_fn(params, batch, key):
    leaves, treedef = tree_flatten(params)
    loss = ce_loss(cnn_apply(params, batch["x"]), batch["y"])
    return loss.detach(), tree_unflatten(treedef, list(torch.autograd.grad(loss, leaves)))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--classes", type=int, default=7, help="C classes per node")
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--partition", default="flat", choices=["flat", "tree"],
                    help="PaME message format: flat vector vs per-leaf "
                         "segments with per-leaf Eq.-(8) accounting")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    m = args.nodes
    ds = SyntheticClassification.make(1024, (28, 28, 1), 10, seed=0, sep=3.0)
    parts = label_skew_partition(ds.labels, m, args.classes, seed=0)
    print(
        f"[hetero] m={m} nodes, C={args.classes} classes/node "
        f"(shard sizes: {[len(p) for p in parts]})"
    )
    nb = NodeBatcher({"x": ds.images, "y": ds.labels}, parts, batch_size=32, seed=0)
    topo = build_topology("complete", m)

    def batch_fn(k):
        b = nb.next()
        return {"x": torch.as_tensor(b["x"], device=dev),
                "y": torch.as_tensor(b["y"], device=dev)}

    xs = torch.as_tensor(ds.images[:512], device=dev)
    ys = torch.as_tensor(ds.labels[:512], device=dev)

    def acc_of(params_mean):
        with torch.no_grad():
            logits = cnn_apply(params_mean, xs)
        return float((logits.argmax(-1) == ys).float().mean())

    # --- PaME ---
    cfg = PaMEConfig(nu=0.7, p=0.3, gamma=1.002, sigma0=10.0, kappa_lo=2,
                     kappa_hi=4, partition=args.partition)
    state, hist = run_pame(0, cnn_init(1, device=dev), m, grad_fn, batch_fn, topo, cfg,
                           num_steps=args.steps, tol_std=0.0, device=dev)
    acc_pame = acc_of(tree_map(lambda x: x.mean(0), state.params))
    print(
        f"[hetero] PaME   : loss {hist['loss'][0]:.3f} -> {hist['loss'][-1]:.3f},"
        f" acc(mean model) = {acc_pame:.3f}"
        f"  [transmits {cfg.p:.0%} of coords, every ~3 rounds]"
    )

    # --- D-PSGD (gossip every round) ---
    mixer = make_mixer(topo, "sparse", device=dev)
    st = B.dpsgd_init(0, B.stack_params(cnn_init(1, device=dev), m))
    losses = []
    for k in range(args.steps):
        st, metrics = B.dpsgd_step(st, batch_fn(k), grad_fn, mixer, 0.05)
        losses.append(float(metrics["loss_mean"]))
    acc_dpsgd = acc_of(tree_map(lambda x: x.mean(0), st.params))
    print(
        f"[hetero] D-PSGD : loss {losses[0]:.3f} -> {losses[-1]:.3f},"
        f" acc(mean model) = {acc_dpsgd:.3f}"
        f"  [transmits 100% of coords, every round]"
    )
    return {"pame": {"loss": hist["loss"], "accuracy": acc_pame},
            "dpsgd": {"loss": losses, "accuracy": acc_dpsgd}}


if __name__ == "__main__":
    main()
