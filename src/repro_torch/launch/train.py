"""End-to-end DFL training driver (port of `repro.launch.train`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
        --variant full --algo pame --nodes 4 --batch 4 --seq 128 --steps 3

Same flags and log lines as the JAX CLI, plus ``--device {cuda,cpu}``
(default ``cuda``; without a card the run raises instead of falling back).
PaME on the static network with one seed is ported: every dynamic-network
scenario, fault, temporal, checkpoint and multi-seed flag raises "not yet
ported", as do the baselines (not in the registry yet).  Steps run
through `repro_torch.core.engine` in ``--chunk``-step chunks with one host
sync per chunk; gossip goes through the sparse neighbour exchange by
default (``--mixing dense`` for the selection-matrix form), and per-step
wire cost (Eq. 8) is logged beside the loss.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core import engine
from repro_torch.core.algorithms import PaMEHp, get_algorithm, list_algorithms
from repro_torch.core.topology import build_topology
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.models.model import init_params, train_loss
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

# flags whose non-default values select code this slice does not port
_NOT_PORTED = (
    ("scenario", "static"), ("churn", None), ("straggler", None),
    ("edge_drop", None), ("burst", None), ("session", None), ("staleness", 0),
    ("resample", 0), ("loss_rate", None), ("loss_burst", None), ("crash", None),
    ("msg_delay", None), ("seeds", 1), ("ckpt_dir", None), ("compile_cache", None),
)


def _hps_from_args(name: str, args):
    if name != "pame":
        raise NotImplementedError(f"--algo {name} not yet ported to repro_torch")
    p_leaf = None
    if getattr(args, "p_leaf", None):
        p_leaf = tuple(float(x) for x in args.p_leaf.split(","))
    return PaMEHp(
        nu=args.nu, p=args.p, gamma=args.gamma, sigma0=args.sigma0,
        kappa_lo=args.kappa_lo, kappa_hi=args.kappa_hi,
        mask_mode="bernoulli",
        partition=getattr(args, "partition", "flat"), p_leaf=p_leaf,
    )


def batch_stream_rng(seed: int, step: int) -> np.random.Generator:
    """The per-step batch-window RNG, independent across steps and runs
    (same stream as the JAX CLI's)."""
    return np.random.default_rng((int(seed), 1000 + int(step)))


def make_lm_task(cfg, m: int, batch: int, seq: int, seed: int, topology: str,
                 device: torch.device):
    """The LM workload of the CLI: (topology, params0, grad_fn, make_batch).

    The corpus, topology and batch windows are the JAX CLI's (numpy, same
    seeds); the initial weights are drawn by torch from `seed`.
    """
    topo = build_topology(topology, m, p=0.5, seed=seed)
    corpus = SyntheticTokens.make(m, 65536, cfg.vocab, seed=seed)
    node_ids = np.arange(m)[:, None, None]
    offsets = np.arange(seq)

    def make_batch(step: int):
        rng = batch_stream_rng(seed, step)
        starts = rng.integers(0, corpus.tokens.shape[1] - seq - 1, (m, batch))
        toks = corpus.tokens[node_ids, starts[..., None] + offsets]
        return {"tokens": torch.as_tensor(toks, dtype=torch.int64, device=device)}

    def grad_fn(p, b, key):
        del key
        leaves, treedef = tree_flatten(p)
        loss = train_loss(p, cfg, b)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), tree_unflatten(treedef, list(grads))

    params0 = init_params(seed, cfg, device=device)
    return topo, params0, grad_fn, make_batch


def build_everything(args):
    for flag, default in _NOT_PORTED:
        if getattr(args, flag) != default:
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} not yet ported to repro_torch"
            )
    device = resolve_device(args.device)
    cfg = get_config(args.arch, args.variant)
    m = args.nodes
    topo, params0, grad_fn, make_batch = make_lm_task(
        cfg, m, args.batch, args.seq, args.seed, args.topology, device
    )
    alg = get_algorithm(args.algo)
    hps = _hps_from_args(args.algo, args)
    bound = alg.bind(grad_fn, topo, hps, mixing=args.mixing, seed=args.seed,
                     device=device)
    stacked = bound.stack_params(params0, m)
    state = bound.init(args.seed + 1, stacked, None)
    n_params = sum(int(np.prod(tuple(x.shape))) for x in tree_leaves(params0))
    return cfg, bound, state, make_batch, n_params, params0


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--variant", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--algo", default="pame", choices=list(list_algorithms()))
    ap.add_argument("--mixing", default="sparse", choices=["sparse", "dense"],
                    help="gossip contraction: padded neighbor gather vs dense")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the run executes (default cuda; raises "
                         "without a card rather than falling back)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8, help="per-node batch")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--topology", default="erdos_renyi")
    ap.add_argument("--scenario", default="static",
                    help="dynamic-network preset (not yet ported: static only)")
    ap.add_argument("--churn", type=float, default=None)
    ap.add_argument("--straggler", type=float, default=None)
    ap.add_argument("--edge-drop", type=float, default=None)
    ap.add_argument("--burst", default=None, metavar="DOWN[,UP]")
    ap.add_argument("--session", default=None, metavar="LEAVE[,REJOIN]")
    ap.add_argument("--staleness", type=int, default=0)
    ap.add_argument("--resample", type=int, default=0)
    ap.add_argument("--mobility-keep", type=float, default=0.7)
    ap.add_argument("--loss-rate", type=float, default=None)
    ap.add_argument("--loss-burst", default=None, metavar="DOWN[,UP]")
    ap.add_argument("--crash", default=None, metavar="RATE[,REJOIN]")
    ap.add_argument("--msg-delay", default=None, metavar="P[,D]")
    ap.add_argument("--repair", dest="repair", action="store_true", default=True)
    ap.add_argument("--no-repair", dest="repair", action="store_false")
    ap.add_argument("--seeds", type=int, default=1,
                    help="seed replicas as batched lanes (not yet ported: 1)")
    ap.add_argument("--chunk", type=int, default=16,
                    help="steps per engine chunk (one host sync per chunk)")
    ap.add_argument("--lr", type=float, default=0.05, help="baseline step size")
    ap.add_argument("--rho", type=float, default=0.01, help="DFedSAM ascent radius")
    ap.add_argument("--nu", type=float, default=0.5)
    ap.add_argument("--p", type=float, default=0.2)
    ap.add_argument("--partition", default="flat", choices=["flat", "tree"],
                    help="PaME message format over the model pytree: 'flat' "
                         "prices one concatenated vector; 'tree' gives each "
                         "leaf its own segment")
    ap.add_argument("--p-leaf", default=None, metavar="R1,R2,...",
                    help="per-leaf transmission rates (tree partition), one "
                         "per pytree leaf in JAX leaf order")
    ap.add_argument("--gamma", type=float, default=1.001)
    ap.add_argument("--sigma0", type=float, default=20.0)
    ap.add_argument("--kappa-lo", type=int, default=3)
    ap.add_argument("--kappa-hi", type=int, default=7)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=None,
                    help="log cadence in steps (chunk-aligned; default=chunk)")
    ap.add_argument("--compile-cache", default=None, metavar="DIR")
    return ap


def main(argv=None) -> dict:
    """Run the CLI; returns {"loss": per-step mean loss, "seconds": wall
    seconds of each chunk, "steps": steps run} for callers such as the
    chip smoke."""
    args = make_parser().parse_args(argv)
    cfg, bound, state, make_batch, n_params, params0 = build_everything(args)
    wire_per_step = bound.wire_bits_for(params0)
    part_tag = f"partition={args.partition} " if args.algo == "pame" else ""
    print(
        f"[train] algo={args.algo} mixing={args.mixing} {part_tag}"
        f"nodes={args.nodes} scenario=static "
        f"params={n_params/1e6:.2f}M wire_bits/step={wire_per_step:.3e} "
        f"({wire_per_step/8e6:.2f} MB/step network-wide) device={bound.device}",
        flush=True,
    )
    del params0
    runner = engine.make_scan_runner(bound.step, chunk_size=args.chunk)
    log_every = max(args.log_every or args.chunk, 1)
    t0 = time.time()
    k = 0
    cum_bits = 0.0
    out = {"loss": [], "seconds": [], "steps": 0}
    while k < args.steps:
        length = min(args.chunk, args.steps - k)
        k0 = k
        tc = time.time()
        state, metrics, info = runner(
            state, make_batch, length, copy_state=False, k_start=k0
        )
        out["seconds"].append(time.time() - tc)
        out["loss"].extend(float(v) for v in metrics["loss_mean"])
        k += info["steps_dispatched"]
        cum_bits += wire_per_step * info["steps_dispatched"]
        if (k // log_every) != (k0 // log_every) or k >= args.steps:
            loss = float(np.mean(metrics["loss_mean"]))
            last = lambda key: float(metrics[key][-1])
            extra = (f" consensus={last('consensus'):.3e}"
                     f" comm_nodes={last('comm_nodes'):.0f}"
                     f" sigma={last('sigma_mean'):.2f}")
            print(
                f"[train] step={k} loss={loss:.4f}{extra}"
                f" wire_gbits={cum_bits/1e9:.4f}"
                f" ({(time.time()-t0)/k:.2f}s/step)",
                flush=True,
            )
    out["steps"] = k
    print("[train] done")
    return out


if __name__ == "__main__":
    main()
