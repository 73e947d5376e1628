"""Quickstart on the PyTorch port: PaME on the paper's Example 1
(decentralized linear regression), the registry race, and Theorem 1.

    PYTHONPATH=src python examples/quickstart_torch.py               # on the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # anywhere

The port of ``examples/quickstart.py``: build a topology, define a
per-node loss, run Algorithm 1, race it against D-PSGD through the
algorithm registry (the sparse exchange, which on the card goes through
the gossip kernel), and inspect the Theorem-1 estimators.  Without
``--device cpu`` it runs on ``cuda`` and raises when no card is present.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import PaMEConfig, build_topology, pme, run_pame
from repro_torch.core import algorithms as ALG
from repro_torch.data.synthetic import make_linear_regression

M, N = 16, 200
CFG = PaMEConfig(nu=0.2, p=0.2, gamma=1.01, sigma0=8.0, kappa_lo=3, kappa_hi=7)
RACE = (("pame", PaMEConfig(nu=0.2, p=0.2, gamma=1.01, sigma0=8.0)),
        ("dpsgd", ALG.DPSGDHp(lr=0.1)))


def grad_fn(w, batch, key):
    aa, yy = batch
    r = aa @ w - yy
    return 0.5 * torch.mean(r**2), aa.T @ r / aa.shape[0]


def problem(dev):
    """Example 1's data on `dev`: b = <a, w*> + 0.5 e, per-node shards."""
    a, b, w_star = make_linear_regression(M, samples_per_node=64, n=N, seed=0)
    a_t, b_t = torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev)

    def objective(w):
        r = torch.einsum("mbn,n->mb", a_t, w) - b_t
        return torch.sum(0.5 * torch.mean(r**2, dim=1))

    return (a_t, b_t), objective, w_star


def example1(dev, steps=400):
    """`run_pame` on Example 1 under the paper's stop rule."""
    batch, objective, w_star = problem(dev)
    topo = build_topology("erdos_renyi", M, p=0.4, seed=1)
    t0 = time.perf_counter()
    state, hist = run_pame(0, torch.zeros(N), M, grad_fn, lambda k: batch, topo, CFG,
                           num_steps=steps, objective_fn=objective, device=dev)
    w_mean = state.params.mean(dim=0).cpu().numpy()
    return {"max_degree": topo.max_degree, "zeta": topo.zeta,
            "objective": hist["objective"], "steps_run": hist["steps_run"],
            "seconds": time.perf_counter() - t0,
            "recovery_error": float(np.linalg.norm(w_mean - w_star))}


def race(dev, steps=8):
    """PaME and D-PSGD through the registry, sparse neighbour exchange."""
    batch, _, _ = problem(dev)
    topo = build_topology("erdos_renyi", M, p=0.4, seed=1)
    out = {}
    for name, hps in RACE:
        bound = ALG.get_algorithm(name).bind(grad_fn, topo, hps, mixing="sparse", device=dev)
        t0 = time.perf_counter()
        _, h = bound.run(0, torch.zeros(N), M, lambda k: batch, steps,
                         tol_std=0.0, chunk_size=steps)
        out[name] = {"loss": h["loss"], "wire_bits_per_step": h["wire_bits_per_step"],
                     "seconds": time.perf_counter() - t0}
    return out


def theorem1(dev, trials=2000):
    """Count-weighted vs naive averaging of node 0's four neighbours."""
    g = torch.Generator(device=dev).manual_seed(0)
    w = torch.as_tensor(np.random.default_rng(0).standard_normal((5, 8)), dtype=torch.float32,
                        device=dev)
    sel = torch.zeros((5, 5), device=dev)
    sel[1:, 0] = 1.0  # node 0 receives from 1..4
    acc_bar = torch.zeros(8, device=dev)
    acc_naive = torch.zeros(8, device=dev)
    for _ in range(trials):
        masks = pme.sample_coordinate_masks(g, 5, 8, s=3)
        masks[0] = False
        acc_bar += pme.pme_average(w, masks, sel)[0]
        acc_naive += pme.naive_average(w, masks, sel)[0]
    return {"target": w[1:].mean(dim=0).cpu().numpy(),
            "count_weighted": (acc_bar / trials).cpu().numpy(),
            "naive": (acc_naive / trials).cpu().numpy()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=400, help="PaME's step cap on Example 1")
    ap.add_argument("--race-steps", type=int, default=8)
    ap.add_argument("--trials", type=int, default=2000, help="Theorem-1 demo draws")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    ex1 = example1(dev, args.steps)
    print(f"graph: m={M}, max degree={ex1['max_degree']}, zeta={ex1['zeta']:.3f}")
    print(
        f"PaME: f went {ex1['objective'][0]:.3f} -> {ex1['objective'][-1]:.3f}"
        f" in {ex1['steps_run']} iterations"
        f" (noise floor = {M * 0.5 * 0.25:.2f})"
    )
    print(f"recovery error ||w_bar - w*|| = {ex1['recovery_error']:.3f}")

    print(f"\nRegistry race ({args.race_steps} steps each, sparse neighbor-exchange gossip):")
    rc = race(dev, args.race_steps)
    for name, h in rc.items():
        print(
            f"  {name:6s} loss {h['loss'][0]:8.3f} -> {h['loss'][-1]:8.3f}"
            f"   wire: {h['wire_bits_per_step']/8e3:8.1f} KB/step"
        )

    print("\nTheorem 1 demo (count-weighted vs naive averaging):")
    th = theorem1(dev, args.trials)
    print("  target mean     :", np.round(th["target"], 3))
    print("  count-weighted  :", np.round(th["count_weighted"], 3), "(unbiased)")
    print("  naive /t        :", np.round(th["naive"], 3), f"(biased ~ s/n = {3/8:.2f}x)")
    return {"example1": ex1, "race": rc, "theorem1": th}


if __name__ == "__main__":
    main()
