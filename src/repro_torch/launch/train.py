"""End-to-end DFL training driver (port of `repro.launch.train`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
        --variant full --algo pame --nodes 4 --batch 4 --seq 128 --steps 3

Same flags and log lines as the JAX CLI, plus ``--device {cuda,cpu}``
(default ``cuda``; without a card the run raises instead of falling back),
``--layers N`` (the configuration at full width, cut to N layers: what
one card holds for the replicated fault variants of BEER and ANQ-NIDS) and
``--remat`` (each layer checkpointed: what 4096-token
sequences need on one card, as the JAX dry run's train step runs).
Every registered algorithm runs (``--algo pame``, ``dpsgd``, ``dfedsam``,
``choco``, ``beer``, ``anq_nids``; ``--lr`` and ``--rho`` reach the
baselines), on the static network or under the JAX CLI's
dynamic-network flags: ``--scenario`` and ``--churn`` / ``--straggler`` /
``--edge-drop`` (i.i.d.), ``--burst`` / ``--session`` / ``--staleness`` /
``--resample`` / ``--mobility-keep`` (Markov dynamics and bounded
staleness), ``--loss-rate`` / ``--loss-burst`` / ``--crash`` /
``--msg-delay`` / ``--no-repair`` (message-level faults).  ``--ckpt-dir``
saves the state (with the auxiliary carry and the realized wire bits)
every ``--ckpt-every`` steps and resumes from the newest intact step
(`repro_torch.checkpoint`, the JAX package's format).  ``--seeds N``
trains N seed replicas as one lane-batched run (`Algorithm.bind_batched`:
lane s starts from key seed + 1 + s, the key an unbatched run of that seed
gets; under any of the network flags above, each lane draws its own
network and the lanes still step as one, their exchange one launch a
leaf) and logs the mean loss across lanes with its spread (``loss_std``)
and the wire bits a lane.  ``--compile-cache DIR`` builds the CUDA
kernels into DIR and loads them from there (`engine.setup_compilation_cache`).
Steps run
through `repro_torch.core.engine` in ``--chunk``-step chunks with one host
sync per chunk; gossip goes through the sparse neighbour exchange by
default (``--mixing dense`` for the selection-matrix form), and per-step
wire cost (Eq. 8, realized under a dynamic network) is logged beside the
loss.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.core import engine
from repro_torch.core.algorithms import (
    AnqNidsHp,
    BeerHp,
    ChocoHp,
    DFedSAMHp,
    DPSGDHp,
    PaMEHp,
    get_algorithm,
    list_algorithms,
)
from repro_torch.core.faults import FaultModel
from repro_torch.core.scenarios import get_scenario, list_scenarios
from repro_torch.core.temporal import TemporalScenario
from repro_torch.core.topology import build_topology
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.models.model import init_params, train_loss
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

def _hps_from_args(name: str, args):
    if name == "pame":
        p_leaf = None
        if getattr(args, "p_leaf", None):
            p_leaf = tuple(float(x) for x in args.p_leaf.split(","))
        return PaMEHp(
            nu=args.nu, p=args.p, gamma=args.gamma, sigma0=args.sigma0,
            kappa_lo=args.kappa_lo, kappa_hi=args.kappa_hi,
            mask_mode="bernoulli",
            partition=getattr(args, "partition", "flat"), p_leaf=p_leaf,
        )
    return {
        "dpsgd": lambda: DPSGDHp(lr=args.lr),
        "dfedsam": lambda: DFedSAMHp(lr=args.lr, rho=args.rho),
        "choco": lambda: ChocoHp(lr=args.lr),
        "beer": lambda: BeerHp(lr=args.lr),
        "anq_nids": lambda: AnqNidsHp(lr=args.lr),
    }[name]()


def batch_stream_rng(seed: int, step: int) -> np.random.Generator:
    """The per-step batch-window RNG, independent across steps and runs
    (same stream as the JAX CLI's)."""
    return np.random.default_rng((int(seed), 1000 + int(step)))


def _parse_rate_pair(spec):
    """Parse "down[,up]" Markov-rate flags (e.g. --burst 0.1,0.3)."""
    if spec is None:
        return None
    parts = [float(x) for x in spec.split(",")]
    if len(parts) == 1:
        parts.append(0.5)
    if len(parts) != 2:
        raise ValueError(f"expected RATE or RATE_DOWN,RATE_UP, got {spec!r}")
    return tuple(parts)


def _scenario_from_args(args):
    """The --scenario preset with per-probability overrides.  Any temporal
    flag (--burst/--session/--staleness/--resample) makes it a
    `TemporalScenario`: explicit Markov rates win, and the i.i.d. churn /
    edge-drop probabilities lower to their degenerate Markov equivalents
    (leave=c, rejoin=1−c reproduces i.i.d. churn bit for bit)."""
    burst = _parse_rate_pair(args.burst)
    session = _parse_rate_pair(args.session)
    scen = get_scenario(args.scenario)
    overrides = {field: value for field, value in (
        ("churn", args.churn), ("straggler", args.straggler), ("edge_drop", args.edge_drop),
    ) if value is not None}
    if overrides:
        scen = dataclasses.replace(scen, name=f"{scen.name}+custom", **overrides)
    scen = dataclasses.replace(scen, seed=args.seed)
    if not (burst or session or args.staleness > 0 or args.resample > 0):
        return scen
    if burst is None:
        burst = (scen.edge_drop, 1.0 - scen.edge_drop) if scen.edge_drop > 0 else (0.0, 0.5)
    if session is None:
        session = (scen.churn, 1.0 - scen.churn) if scen.churn > 0 else (0.0, 0.5)
    return TemporalScenario(
        name=f"{scen.name}+temporal",
        burst_down=burst[0], burst_up=burst[1],
        leave=session[0], rejoin=session[1],
        straggler=scen.straggler, staleness=args.staleness,
        resample_every=args.resample, mobility_keep=args.mobility_keep,
        seed=args.seed,
    )


def _faults_from_args(args):
    """The message-level fault flags as a FaultModel (or None): --loss-rate
    (i.i.d. per-direction drops), --loss-burst (Gilbert–Elliott lossy
    links), --crash (transient crashes, state frozen while down),
    --msg-delay (delayed delivery only).  All compose with --scenario."""
    burst = _parse_rate_pair(args.loss_burst)
    crash = _parse_rate_pair(args.crash)
    delay_p, delay_d = 0.0, 0
    if args.msg_delay is not None:
        parts = args.msg_delay.split(",")
        delay_p = float(parts[0])
        delay_d = int(parts[1]) if len(parts) > 1 else 2
    if args.loss_rate is None and burst is None and crash is None and args.msg_delay is None:
        return None
    return FaultModel(
        name="cli",
        loss=args.loss_rate or 0.0,
        burst_down=burst[0] if burst else 0.0,
        burst_up=burst[1] if burst else 0.5,
        crash=crash[0] if crash else 0.0,
        rejoin=crash[1] if crash else 0.5,
        delay=delay_p,
        max_delay=delay_d,
        repair=args.repair,
        seed=args.seed,
    )


def lm_batch_fn(cfg, m: int, batch: int, seq: int, seed: int, device: torch.device):
    """Per-node LM batches for m nodes: ``make_batch(step) -> {"tokens":
    [m, batch, seq]}`` (a vlm also gets zero ``patch_embeds`` [m, batch,
    n_patches, vision_dim] in the model's type), the JAX CLI's corpus and
    windows (numpy, same seeds).  The corpus draws node shards in order,
    so the first m shards are the same for any larger m (incumbents keep
    their data at a join)."""
    corpus = SyntheticTokens.make(m, 65536, cfg.vocab, seed=seed)
    node_ids = np.arange(m)[:, None, None]
    offsets = np.arange(seq)

    def make_batch(step: int):
        rng = batch_stream_rng(seed, step)
        starts = rng.integers(0, corpus.tokens.shape[1] - seq - 1, (m, batch))
        toks = corpus.tokens[node_ids, starts[..., None] + offsets]
        out = {"tokens": torch.as_tensor(toks, dtype=torch.int64, device=device)}
        if cfg.arch_type == "vlm":
            out["patch_embeds"] = torch.zeros((m, batch, cfg.n_patches, cfg.vision_dim),
                                              dtype=getattr(torch, cfg.dtype), device=device)
        return out

    return make_batch


def lm_grad_fn(cfg):
    """``grad_fn(params, batch, key) -> (loss, grads)`` of one node's LM loss."""

    def grad_fn(p, b, key):
        del key
        leaves, treedef = tree_flatten(p)
        loss = train_loss(p, cfg, b)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), tree_unflatten(treedef, list(grads))

    return grad_fn


def make_lm_task(cfg, m: int, batch: int, seq: int, seed: int, topology: str,
                 device: torch.device):
    """The LM workload of the CLI: (topology, params0, grad_fn, make_batch).

    The corpus, topology and batch windows are the JAX CLI's (numpy, same
    seeds); the initial weights are drawn by torch from `seed`.
    """
    topo = build_topology(topology, m, p=0.5, seed=seed)
    make_batch = lm_batch_fn(cfg, m, batch, seq, seed, device)
    params0 = init_params(seed, cfg, device=device)
    return topo, params0, lm_grad_fn(cfg), make_batch


def dir_bytes(path: str) -> int:
    """Bytes of the files under a checkpoint step directory."""
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def build_everything(args):
    device = resolve_device(args.device)
    cfg = get_config(args.arch, args.variant)
    if args.layers is not None:
        cfg = cfg.replace(n_layers=args.layers)
    if args.remat:
        cfg = cfg.replace(remat=True, remat_policy="full")
    if args.seq and cfg.arch_type == "vlm" and args.seq <= cfg.n_patches:
        raise ValueError(f"--seq must exceed n_patches ({cfg.n_patches}) for a vlm")
    m = args.nodes
    topo, params0, grad_fn, make_batch = make_lm_task(
        cfg, m, args.batch, args.seq, args.seed, args.topology, device
    )
    alg = get_algorithm(args.algo)
    hps = _hps_from_args(args.algo, args)
    batch0 = make_batch(0) if alg.needs_batch0 else None
    net = dict(mixing=args.mixing, seed=args.seed, scenario=_scenario_from_args(args),
               faults=_faults_from_args(args), device=device)
    if args.seeds > 1:
        # one lane-batched run of the seed replicas: lane s starts from key
        # seed + 1 + s, the key the unbatched run of that seed would use
        bound = alg.bind_batched(grad_fn, topo, [hps],
                                 seeds=[args.seed + 1 + i for i in range(args.seeds)], **net)
        state = bound.init(params0, m, batch0)
    else:
        bound = alg.bind(grad_fn, topo, hps, **net)
        state = bound.init(args.seed + 1, bound.stack_params(params0, m), batch0)
    n_params = sum(int(np.prod(tuple(x.shape))) for x in tree_leaves(params0))
    return cfg, bound, state, make_batch, n_params, params0


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--variant", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the configuration's depth to N layers (full "
                         "width kept; default: the configuration's depth)")
    ap.add_argument("--remat", action="store_true",
                    help="checkpoint each layer of the training pass (the "
                         "\"full\" policy; default: no remat)")
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
    ap.add_argument("--scenario", default="static", choices=list(list_scenarios()),
                    help="dynamic-network preset: per-step link churn, node "
                         "dropout, stragglers (see repro_torch.core.scenarios)")
    ap.add_argument("--churn", type=float, default=None,
                    help="override: P[node fully offline per step]")
    ap.add_argument("--straggler", type=float, default=None,
                    help="override: P[node misses the exchange per step]")
    ap.add_argument("--edge-drop", type=float, default=None,
                    help="override: P[link fails per step]")
    ap.add_argument("--burst", default=None, metavar="DOWN[,UP]",
                    help="Gilbert-Elliott per-link burst rates: P[good->bad]"
                         "[,P[bad->good]] per step (temporal scenario)")
    ap.add_argument("--session", default=None, metavar="LEAVE[,REJOIN]",
                    help="geometric node sessions: P[up->down][,P[down->up]]"
                         " per step (temporal scenario)")
    ap.add_argument("--staleness", type=int, default=0,
                    help="bounded staleness D: stragglers keep participating"
                         " through their <=D-step-old params from the "
                         "snapshot ring (0 = miss the round)")
    ap.add_argument("--resample", type=int, default=0,
                    help="mobility: redraw the active edge subset every N "
                         "steps (0 = off)")
    ap.add_argument("--mobility-keep", type=float, default=0.7,
                    help="P[base edge active within a mobility epoch]")
    ap.add_argument("--loss-rate", type=float, default=None,
                    help="message-level faults: P[a directed message is "
                         "dropped] per step (asymmetric per direction)")
    ap.add_argument("--loss-burst", default=None, metavar="DOWN[,UP]",
                    help="Gilbert-Elliott lossy-link chain per directed "
                         "slot: P[good->lossy][,P[lossy->good]] per step")
    ap.add_argument("--crash", default=None, metavar="RATE[,REJOIN]",
                    help="transient node crashes: P[up->crashed]"
                         "[,P[crashed->recovered]] per step; crashed state "
                         "freezes")
    ap.add_argument("--msg-delay", default=None, metavar="P[,D]",
                    help="delayed delivery: P[a node's outgoing messages "
                         "are late][,staleness bound D (default 2)]; "
                         "message-only — local compute never waits")
    ap.add_argument("--repair", dest="repair", action="store_true", default=True,
                    help="surrogate algorithms resync desynced per-receiver "
                         "replicas by full-surrogate retransmission, charged "
                         "on the wire (default)")
    ap.add_argument("--no-repair", dest="repair", action="store_false",
                    help="no replica repair: lost innovations desync "
                         "surrogates permanently")
    ap.add_argument("--seeds", type=int, default=1,
                    help="seed replicas trained together as batched lanes")
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
    ap.add_argument("--compile-cache", default=None, metavar="DIR",
                    help="directory the CUDA kernels are built into and loaded "
                         "from (default: $REPRO_COMPILE_CACHE; unset = the "
                         "checkout's build/repro_torch_kernels/)")
    return ap


def _resume(args, state, aux, carries_aux: bool):
    """(state, aux, start step, realized wire bits or None, restore record)
    from the newest checkpoint under --ckpt-dir, as the JAX CLI resumes:
    the payload carries the auxiliary carry and the cumulative realized
    wire bits; a legacy payload without the bits restores too."""
    os.makedirs(args.ckpt_dir, exist_ok=True)
    last = latest_step(args.ckpt_dir)
    if last is None:
        return state, aux, 0, None, None
    t0 = time.perf_counter()
    payload = {"state": state, "cum_bits": np.zeros((), np.float64)}
    if carries_aux:
        payload["aux"] = aux
    resumed_bits = None
    try:
        restored = restore_checkpoint(args.ckpt_dir, payload, last)
        resumed_bits = float(restored["cum_bits"])
    except ValueError:
        # legacy checkpoint (no cum_bits leaf): the old payload's shape
        if carries_aux:
            restored = restore_checkpoint(args.ckpt_dir, {"state": state, "aux": aux}, last)
        else:
            restored = {"state": restore_checkpoint(args.ckpt_dir, state, last)}
    record = {"step": last, "seconds": time.perf_counter() - t0,
              "bytes": dir_bytes(os.path.join(args.ckpt_dir, f"step_{last:09d}"))}
    print(f"[train] resumed from step {last}")
    return restored["state"], restored.get("aux") if carries_aux else None, last, \
        resumed_bits, record


def main(argv=None, *, return_state: bool = False) -> dict:
    """Run the CLI; returns {"loss": per-step mean loss, "seconds": wall
    seconds of each chunk, "steps": the step reached, "start": the step it
    resumed from (0 without a checkpoint), "metrics": every per-step metric
    by name, "staleness_hist": the run's histogram or None, "checkpoints":
    each save's step, seconds and bytes, "restore": the resume's, or None}
    for callers such as the chip smoke; with ``return_state`` also "state",
    the algorithm's final state (it stays on the device)."""
    args = make_parser().parse_args(argv)
    cache_dir = engine.setup_compilation_cache(args.compile_cache)
    if cache_dir:
        print(f"[train] compilation cache at {cache_dir}", flush=True)
    cfg, bound, state, make_batch, n_params, params0 = build_everything(args)
    lanes = bound.lanes if args.seeds > 1 else None
    wire_per_step = bound.wire_bits_for(params0)
    scen_tag = bound.scenario.name if bound.dynamic else "static"
    if bound.faulty:
        fm = bound.faults
        scen_tag += (
            f"+faults(loss={fm.loss}, burst={fm.burst_down}/{fm.burst_up}, "
            f"crash={fm.crash}/{fm.rejoin}, delay={fm.delay}<= {fm.max_delay}, "
            f"repair={fm.repair})"
        )
    part_tag = f"partition={args.partition} " if args.algo == "pame" else ""
    print(
        f"[train] algo={args.algo} mixing={args.mixing} {part_tag}"
        f"nodes={args.nodes} scenario={scen_tag} "
        + (f"seeds={args.seeds} (batched lanes) " if lanes else "")
        + f"params={n_params/1e6:.2f}M wire_bits/step={wire_per_step:.3e} "
        f"({wire_per_step/8e6:.2f} MB/step network-wide"
        f"{'; full graph — realized bits logged per step' if bound.dynamic else ''})"
        f" device={bound.device}",
        flush=True,
    )
    del params0
    aux = bound.aux_init(state) if bound.carries_aux else None
    start, resumed_bits, restore = 0, None, None
    if args.ckpt_dir:
        state, aux, start, resumed_bits, restore = _resume(args, state, aux,
                                                           bound.carries_aux)
    runner = engine.make_scan_runner(bound.step, chunk_size=args.chunk,
                                     step_takes_index=bound.dynamic,
                                     carries_aux=bound.carries_aux, lanes=lanes)
    log_every = max(args.log_every or args.chunk, 1)
    t0 = time.time()
    k = start
    # the realized bits of the resumed steps, else the static estimate
    cum_bits = resumed_bits if resumed_bits is not None else wire_per_step * start
    stale_hist = None
    next_ckpt = (start // args.ckpt_every + 1) * args.ckpt_every
    out = {"loss": [], "seconds": [], "steps": 0, "start": start, "metrics": {},
           "staleness_hist": None, "checkpoints": [], "restore": restore}
    while k < args.steps:
        length = min(args.chunk, args.steps - k)
        k0 = k
        tc = time.time()
        # k_start keeps batches and realizations aligned with the global step
        box, state = engine.Donated(state), None  # freed after the chunk's first step
        state, metrics, info = runner(box, make_batch, length, k_start=k0, aux=aux)
        aux = info["aux"]
        out["seconds"].append(time.time() - tc)
        # a lane-batched run logs each step's mean over the lanes
        out["loss"].extend(float(np.mean(v)) for v in metrics["loss_mean"])
        for key, vals in metrics.items():
            out["metrics"].setdefault(key, []).extend(np.asarray(vals).tolist())
        k += info["steps_dispatched"]
        if "wire_bits" in metrics:  # realized (surviving-edge) accounting
            # lane-batched rows are [steps, L]: the average a lane, so the
            # log stays comparable with a single-seed run
            cum_bits += float(np.sum(metrics["wire_bits"])) / (lanes or 1)
        else:
            cum_bits += wire_per_step * info["steps_dispatched"]
        if "stale_hist" in metrics:  # per-run staleness occupancy histogram
            rows = np.asarray(metrics["stale_hist"])
            row = rows.reshape(-1, rows.shape[-1]).sum(axis=0)
            stale_hist = row if stale_hist is None else stale_hist + row
        if (k // log_every) != (k0 // log_every) or k >= args.steps:
            lm = np.asarray(metrics["loss_mean"])
            loss = float(np.mean(lm))
            last = lambda key: float(np.mean(np.asarray(metrics[key])[-1]))  # noqa: E731
            extra = ""
            if lanes:  # the seed replicas' spread at the last step
                extra += f" loss_std={float(np.std(lm[-1])):.4f}"
            for key, fmt in (("consensus", " consensus={:.3e}"), ("comm_nodes", " comm_nodes={:.0f}"),
                             ("alive_nodes", " alive={:.0f}"), ("stale_nodes", " stale={:.0f}"),
                             ("crashed_nodes", " crashed={:.0f}"),
                             ("dropped_msgs", " dropped={:.0f}"), ("mean_drift", " drift={:.3f}"),
                             ("surrogate_desync", " desync={:.3e}"),
                             ("sigma_mean", " sigma={:.2f}")):
                if key in metrics:
                    extra += fmt.format(last(key))
            print(
                f"[train] step={k} loss={loss:.4f}{extra}"
                f" wire_gbits={cum_bits/1e9:.4f}"
                f" ({(time.time()-t0)/(k-start):.2f}s/step)",
                flush=True,
            )
        if args.ckpt_dir and k >= next_ckpt:
            payload = {"state": state, "cum_bits": np.asarray(cum_bits, np.float64)}
            if bound.carries_aux:
                payload["aux"] = aux
            tc = time.perf_counter()
            step_dir = save_checkpoint(args.ckpt_dir, k, payload)
            out["checkpoints"].append({"step": k, "seconds": time.perf_counter() - tc,
                                       "bytes": dir_bytes(step_dir)})
            next_ckpt = (k // args.ckpt_every + 1) * args.ckpt_every
    out["steps"] = k
    if stale_hist is not None:
        out["staleness_hist"] = stale_hist.tolist()
        total = max(float(stale_hist.sum()), 1.0)
        cells = " ".join(f"tau={t}:{int(c)}({c / total:.0%})" for t, c in enumerate(stale_hist))
        print(f"[train] staleness histogram (participant-steps): {cells}")
    print("[train] done")
    if return_state:
        out["state"] = state
    return out


if __name__ == "__main__":
    main()
