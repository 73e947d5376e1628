"""Serve-while-train driver: training rounds interleaved with inference (port
of `repro.launch.serve_train`).

Every node fields a stream of decode requests while it trains.  Arrivals
(Poisson or Markov-modulated bursts, `repro_torch.serve.events`) pace the
gossip rounds: a backlogged node defers its exchange like a straggler but
keeps taking local steps.  Between training chunks the driver serves real
batched greedy decode against the nodes' current parameters
(`repro_torch.serve.serving`) and logs each node's latency, throughput and
the staleness of the served model.

Elastic membership: ``--join STEP:N[:DEGREE]`` grows the node set mid-run
(`repro_torch.serve.membership`): new nodes attach to uniform existing
nodes, the Metropolis–Hastings weights are re-derived (doubly stochastic,
checked at every join), and each joiner catches up by cloning a trained
neighbour from the newest checkpoint (``--ckpt-dir``) or, without one, the
live state.  ``--chaos "leave@20:2,partition@40:bridge,heal@80,join@90:1"``
composes graceful departures (mass handoff, mean-preserving, checked),
scheduled partitions (cross-component cuts, healed) and joins, with
invariant monitors at every event.  An empty timeline runs the plain path
bit for bit.  ``--serve-policy consensus`` serves every request from the
node's component's mean model instead of its own.

    PYTHONPATH=src python -m repro_torch.launch.serve_train --arch stablelm-1.6b \\
        --steps 8 --nodes 5 --join 4:1 --arrival bursty --prompt-len 8 --gen 4 \\
        --serve-batch 2 --device cpu

The JAX CLI's flags, plus ``--device {cuda,cpu}`` (default ``cuda``;
without a card the run raises instead of falling back) and ``--layers N``
(the configuration at full width cut to N layers).  ``--compile-cache
DIR`` builds the CUDA kernels into DIR (`engine.setup_compilation_cache`).
What differs from JAX: the event clock draws
from the port's own generators (`serve.events`); every rebind builds the
mixer, scenario arrays and gossip tables for the new m, and nothing keeps
the old m's state; the parameter means the leave check and the heal's
drift compare are taken on the device, leaf by leaf in f32, and only the
compared numbers come back; and the leave check holds a bf16 leaf to the
rounding of its one store per survivor element (`_leave_conformance`).

`main` returns ``(state, record)``: the final state, as JAX's returns it,
and a dict of what the run measured (per-step losses, each chunk, each
event, each serve round, each checkpoint, and the serving summary).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from collections import deque

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointCorruptError, restore_checkpoint, save_checkpoint
from repro_torch.checkpoint.store import latest_step
from repro_torch.configs import get_config
from repro_torch.core import engine
from repro_torch.core import scenarios as scen_mod
from repro_torch.core.algorithms import get_algorithm, list_algorithms
from repro_torch.core.faults import FaultModel
from repro_torch.core.scenarios import get_scenario, list_scenarios
from repro_torch.core.topology import build_topology
from repro_torch.launch.train import _hps_from_args, dir_bytes, lm_batch_fn, lm_grad_fn
from repro_torch.models.model import init_params
from repro_torch.serve import events as ev_mod
from repro_torch.serve import membership as mb_mod
from repro_torch.serve.serving import ServeLoop
from repro_torch.tree import tree_leaves


def _pacing_from_args(args) -> ev_mod.ServePacing:
    proc = ev_mod.get_arrival(args.arrival)
    overrides = {}
    if args.rate is not None:
        overrides["rate"] = args.rate
    if args.burst_rate is not None:
        overrides["burst_rate"] = args.burst_rate
    if overrides:
        proc = dataclasses.replace(proc, name=f"{proc.name}+custom", **overrides)
    proc = dataclasses.replace(proc, seed=args.seed)
    return ev_mod.ServePacing(process=proc, capacity=args.serve_capacity,
                              defer_threshold=args.defer_threshold)


def _make_batch_fn(args, cfg, m, device):
    """Per-node LM batches for the current node count; the first m_old
    shards are the same when m grows, so incumbents keep their data."""
    return lm_batch_fn(cfg, m, args.batch, args.seq, args.seed, device)


def _bind_for(args, topo, pacing, faults, grad_fn, device, partitions=()):
    """(Re)bind the algorithm over the current topology, at the start and
    after every membership change: the mixer, the scenario arrays and the
    gossip tables are built for the new m.  Chaos partition windows fold
    into the scenario, so the realization cuts cross-component edges while
    a window is open."""
    alg = get_algorithm(args.algo)
    hps = _hps_from_args(args.algo, args)
    scen = dataclasses.replace(get_scenario(args.scenario), seed=args.seed)
    if partitions:
        scen = dataclasses.replace(scen, partitions=tuple(partitions))
    bound = alg.bind(grad_fn, topo, hps, mixing=args.mixing, seed=args.seed,
                     scenario=None if scen.is_static else scen, faults=faults,
                     pacing=pacing, device=device)
    runner = engine.make_scan_runner(bound.step, chunk_size=args.chunk,
                                     step_takes_index=bound.dynamic,
                                     carries_aux=bound.carries_aux)
    return bound, runner


def _join_conformance(topo_new, m_old: int, kind="join") -> dict:
    """The membership conformance suite, run at every join and leave: the
    re-derived mixing matrix stays doubly stochastic and mean-preserving
    over the changed node set."""
    w = topo_new.mixing
    rows_ok = bool(np.allclose(w.sum(axis=1), 1.0, atol=1e-9))
    cols_ok = bool(np.allclose(w.sum(axis=0), 1.0, atol=1e-9))
    x = np.random.default_rng(0).standard_normal((topo_new.m, 7))
    mean_ok = bool(np.allclose((w @ x).mean(axis=0), x.mean(axis=0), atol=1e-9))
    if not (rows_ok and cols_ok and mean_ok):
        raise AssertionError(
            f"{kind} conformance FAILED at m={m_old}->{topo_new.m}: "
            f"rows={rows_ok} cols={cols_ok} mean={mean_ok}")
    return {"rows": rows_ok, "cols": cols_ok, "mean": mean_ok}


def _params_mean(bound, state) -> list:
    """The global parameter mean, one f32 tensor per leaf on its device
    (`membership.node_mean`, a block of columns at a time): the quantity a
    graceful departure must preserve."""
    with torch.no_grad():
        return [mb_mod.node_mean(leaf) for leaf in tree_leaves(bound.params_of(state))]


def _half_ulp_bf16(x: float) -> float:
    """Half a bf16 ulp (8 significant bits) at magnitude x."""
    x = max(abs(float(x)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(x)) - 8)


def _leave_conformance(pre_mean: list, bound, state, m_old: int, m_new: int) -> dict:
    """Departure invariant: the survivors' parameter mean equals the
    pre-departure mean, held at what the leaf's type can hold.

    The handoff is mean-preserving, but each survivor's new row is stored
    once in its leaf's type.  f32 leaves are held at the reference's f32
    tolerance (atol 1e-5·scale, rtol 1e-5, scale = max(max|mean|, 1)); a
    bf16 leaf at half a bf16 ulp of its largest magnitude on top of that,
    the rounding of that one store per element.  Returns the worst drift
    and its tolerance, over the leaves, for the record."""
    scale = max(max(float(x.abs().max()) for x in pre_mean), 1.0)
    worst = {"drift": 0.0, "tol": 0.0, "ratio": 0.0}
    with torch.no_grad():
        for pre, leaf in zip(pre_mean, tree_leaves(bound.params_of(state))):
            post = mb_mod.node_mean(leaf)
            atol = 1e-5 * scale
            if leaf.dtype == torch.bfloat16:
                lo, hi = torch.aminmax(leaf)
                atol += _half_ulp_bf16(max(-float(lo), float(hi)))
            excess = ((post - pre).abs() - 1e-5 * pre.abs()).max().item()
            drift = (post - pre).abs().max().item()
            if excess > atol:
                raise AssertionError(
                    f"leave conformance FAILED at m={m_old}->{m_new}: survivor mean "
                    f"drifted by {drift:.3e} (tolerance {atol:.3e} at {leaf.dtype} "
                    "exceeded)")
            if excess / atol > worst["ratio"]:
                worst = {"drift": drift, "tol": atol, "ratio": excess / atol}
            del post
    return worst


def _active_comp(bound, k):
    """The step's component-id vector (numpy), or None when the bind
    schedules no partitions (one global component)."""
    arrays = getattr(bound, "scen_arrays", None)
    if arrays is None or arrays.part_comp is None:
        return None
    return scen_mod.active_components(arrays, int(k)).cpu().numpy()


def _chaos_monitor(bound, k: int, tag: str) -> dict:
    """In-run invariant monitor for chaos runs: realizes step k's matrix on
    the host and asserts Assumption 1's invariants: row and column
    stochasticity at f32 tolerance, zero cross-component mass while a
    partition window is open, and per-component (hence global) mean
    preservation."""
    if not bound.dynamic or bound.temporal:
        return {}
    arrays = bound.scen_arrays
    r = scen_mod.realize(bound.scenario, arrays, int(k))
    w = scen_mod.realization_matrix(arrays, r).numpy().astype(np.float64)
    row_defect = float(np.max(np.abs(w.sum(axis=1) - 1.0)))
    col_defect = float(np.max(np.abs(w.sum(axis=0) - 1.0)))
    assert row_defect < 1e-4 and col_defect < 1e-4, (
        f"{tag}: stochasticity defect rows={row_defect:.2e} cols={col_defect:.2e} at k={k}")
    comp = _active_comp(bound, k)
    x = np.random.default_rng(1).standard_normal((w.shape[0], 5))
    cross = 0.0
    if comp is not None and comp.max() > 0:
        cross = float(w[comp[:, None] != comp[None, :]].sum())
        assert cross == 0.0, (
            f"{tag}: {cross:.2e} cross-component mass inside an open partition "
            f"window at k={k}")
        for c in np.unique(comp):
            sel = comp == c
            assert np.allclose((w @ x)[sel].mean(axis=0), x[sel].mean(axis=0), atol=1e-5), (
                f"{tag}: component {c} mean not preserved at k={k}")
    else:
        assert np.allclose((w @ x).mean(axis=0), x.mean(axis=0), atol=1e-5), (
            f"{tag}: global mean not preserved")
    print(f"[serve-train] monitor@{k} {tag}: stochasticity defect "
          f"{max(row_defect, col_defect):.1e}, mean-preserving (green)", flush=True)
    return {"defect": max(row_defect, col_defect), "cross_mass": cross, "green": True}


def _comp_drift(bound, state, comp) -> float:
    """Max ℓ2 gap between any component's parameter mean and the global
    mean: the drift a heal hands back to gossip to reconcile
    (`scenarios.component_stats`' comp_mean_gap: on the device, in f32, a
    leaf and a block of columns at a time)."""
    with torch.no_grad():
        _, gap = scen_mod.component_stats(torch.as_tensor(comp),
                                          tree_leaves(bound.params_of(state)),
                                          int(np.max(comp)) + 1)
    return float(gap)


def _serve_report(tag, stats, es=None):
    """One log line per served node: decode throughput from the serve loop,
    queueing latency (staleness of the served model) from the event clock,
    Little's law wait_i / served_i rounds."""
    for i, s in sorted(stats.items()):
        extra = ""
        if es is not None:
            served = max(int(es.served[i]), 1)
            lat = float(es.wait[i]) / served
            extra = f" queue={int(es.queue[i])} latency={lat:.2f} rounds (model-staleness)"
        print(f"{tag} node={i} prefill={s['prefill_ms']:.0f}ms "
              f"decode={s['decode_ms']:.0f}ms "
              f"tokens/s={s['tokens_per_s']:.1f}{extra}", flush=True)


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--variant", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the configuration's depth to N layers (full "
                         "width kept; default: the configuration's depth)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the run executes (default cuda; raises "
                         "without a card rather than falling back)")
    ap.add_argument("--algo", default="pame", choices=list(list_algorithms()))
    ap.add_argument("--mixing", default="sparse", choices=["sparse", "dense"])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=4, help="per-node batch")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--topology", default="erdos_renyi")
    ap.add_argument("--scenario", default="static", choices=list(list_scenarios()))
    ap.add_argument("--chunk", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    # training hps (shared with launch.train's _hps_from_args)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--rho", type=float, default=0.01)
    ap.add_argument("--nu", type=float, default=0.5)
    ap.add_argument("--p", type=float, default=0.2)
    ap.add_argument("--gamma", type=float, default=1.001)
    ap.add_argument("--sigma0", type=float, default=20.0)
    ap.add_argument("--kappa-lo", type=int, default=3)
    ap.add_argument("--kappa-hi", type=int, default=7)
    # serving: arrivals pace the rounds, decode traffic is served between
    # training chunks
    ap.add_argument("--arrival", default="bursty", choices=list(ev_mod.list_arrivals()),
                    help="request arrival preset (repro_torch.serve.events)")
    ap.add_argument("--rate", type=float, default=None,
                    help="override: quiet-state arrivals/node/round")
    ap.add_argument("--burst-rate", type=float, default=None,
                    help="override: burst-state arrivals/node/round")
    ap.add_argument("--serve-capacity", type=int, default=4,
                    help="requests a node can serve per round")
    ap.add_argument("--defer-threshold", type=int, default=8,
                    help="backlog beyond which a node defers its gossip")
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen", type=int, default=4,
                    help="tokens generated per served request batch")
    ap.add_argument("--serve-batch", type=int, default=2,
                    help="requests batched into one decode call")
    ap.add_argument("--serve-every", type=int, default=None,
                    help="serve a decode round every N training steps "
                         "(chunk-aligned; default=chunk)")
    ap.add_argument("--serve-nodes", type=int, default=2,
                    help="nodes served per decode round (round-robin)")
    # elastic membership
    ap.add_argument("--join", default=None, metavar="STEP:N[:DEG],...",
                    help="membership joins: N new nodes at STEP, each attached "
                         "to DEG uniform existing nodes (default --join-degree); "
                         "catch-up clones a trained neighbour from --ckpt-dir "
                         "or the live state")
    ap.add_argument("--join-degree", type=int, default=2)
    ap.add_argument("--chaos", default=None, metavar="KIND@STEP[:ARG],...",
                    help="chaos timeline composed with --join: leave@S:N (N "
                         "highest-id nodes depart gracefully), "
                         "partition@S:P|bridge (split into P components), "
                         "heal@S, join@S:N[:DEG].  An empty timeline keeps the "
                         "plain path bit for bit")
    ap.add_argument("--serve-policy", default="local", choices=["local", "consensus"],
                    help="what each node serves from: its own model (freshest) "
                         "or its connected component's mean model (coherent "
                         "failover during splits and departures)")
    # faults (to compose, and to show the crash + membership refusal)
    ap.add_argument("--loss-rate", type=float, default=None,
                    help="P[a directed message is dropped] per step")
    ap.add_argument("--crash", default=None, metavar="RATE[,REJOIN]",
                    help="fixed-m transient crashes; refused with membership "
                         "changes (membership.check_membership_faults)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--compile-cache", default=None, metavar="DIR")
    return ap


def _faults_from_args(args):
    crash = None
    if args.crash is not None:
        parts = [float(x) for x in args.crash.split(",")]
        crash = (parts[0], parts[1] if len(parts) > 1 else 0.5)
    if args.loss_rate is None and crash is None:
        return None
    return FaultModel(name="cli", loss=args.loss_rate or 0.0,
                      crash=crash[0] if crash else 0.0,
                      rejoin=crash[1] if crash else 0.5, seed=args.seed)


def _peak(device):
    """The card's peak allocated bytes so far (since the caller's last reset
    of the peak), or None on the CPU: which phase of the run set the peak."""
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None


def _rows_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def main(argv=None, observe=None):
    """Run the CLI; returns ``(state, record)``.  ``observe(event_record,
    state)``, when given, is called after each membership or partition
    event with the state the run continues from (the chip smoke holds the
    catch-up against the checkpoint with it)."""
    args = make_parser().parse_args(argv)
    cache_dir = engine.setup_compilation_cache(args.compile_cache)
    if cache_dir:
        print(f"[serve-train] compilation cache at {cache_dir}", flush=True)
    device = resolve_device(args.device)

    timeline = mb_mod.parse_chaos_spec(args.chaos, args.join_degree)
    events = deque(sorted(
        timeline + tuple(
            mb_mod.ChaosEvent(step=e.step, kind="join", n=e.n_new, degree=e.degree)
            for e in mb_mod.parse_join_spec(args.join, args.join_degree)
        ),
        key=lambda e: e.step,
    ))
    faults = _faults_from_args(args)
    if events:
        mb_mod.check_membership_faults(faults, tuple(events), m0=args.nodes)
    windows = mb_mod.chaos_partitions(tuple(events), args.steps, seed=args.seed)
    pacing = _pacing_from_args(args)

    cfg = get_config(args.arch, args.variant)
    if args.layers is not None:
        cfg = cfg.replace(n_layers=args.layers)
    grad_fn = lm_grad_fn(cfg)
    m = args.nodes
    topo = build_topology(args.topology, m, p=0.5, seed=args.seed)
    bound, runner = _bind_for(args, topo, pacing, faults, grad_fn, device, windows)
    make_batch = _make_batch_fn(args, cfg, m, device)

    params0 = init_params(args.seed, cfg, device=device)
    n_params = sum(int(np.prod(tuple(x.shape))) for x in tree_leaves(params0))
    stacked = bound.stack_params(params0, m)
    del params0
    batch0 = make_batch(0) if bound.spec.needs_batch0 else None
    state = bound.init(args.seed + 1, stacked, batch0)
    del stacked, batch0
    aux = bound.aux_init(state) if bound.carries_aux else None

    serve = ServeLoop(cfg, prompt_len=args.prompt_len, gen=args.gen,
                      batch=args.serve_batch, seed=args.seed, device=device)
    ev_summary = [f"{e.kind}@{e.step}" + (f":{e.n}" if e.n else "") for e in events]
    print(
        f"[serve-train] algo={args.algo} nodes={m} "
        f"arrival={pacing.process.name} "
        f"(rate={pacing.process.rate}/{pacing.process.burst_rate} "
        f"cap={pacing.capacity} defer>{pacing.defer_threshold}) "
        f"events={ev_summary or 'none'} "
        f"serve-policy={args.serve_policy} "
        f"params={n_params / 1e6:.2f}M device={device}",
        flush=True,
    )
    if args.ckpt_dir:
        os.makedirs(args.ckpt_dir, exist_ok=True)

    record = {"losses": [], "chunks": [], "events": [], "serves": [], "checkpoints": [],
              "catch_up_restores": [], "summary": {}}
    serve_every = max(args.serve_every or args.chunk, 1)
    t0 = time.time()
    k = 0
    serve_cursor = 0  # round-robin over nodes
    next_serve = serve_every
    next_ckpt = args.ckpt_every
    deferred_total = 0.0
    while k < args.steps:
        boundary = args.steps
        if events:
            boundary = min(boundary, events[0].step)
        if k >= boundary:  # an event at or before the current step
            boundary = min(args.steps, k + args.chunk)
        length = min(args.chunk, boundary - k)
        if length > 0:
            tc = time.perf_counter()
            box, state = engine.Donated(state), None  # freed after the chunk's first step
            state, metrics, info = runner(box, make_batch, length, k_start=k, aux=aux)
            secs = time.perf_counter() - tc
            aux = info.get("aux") if bound.carries_aux else None
            k += info["steps_dispatched"]
            losses = [float(v) for v in metrics["loss_mean"]]
            record["losses"].extend(losses)
            loss = float(np.mean(losses))
            chunk = {"k": k, "m": m, "steps": length, "seconds": secs, "loss": loss,
                     "peak_bytes": _peak(device)}
            extra = ""
            if "deferred_nodes" in metrics:
                d = float(np.sum(metrics["deferred_nodes"]))
                deferred_total += d
                chunk["deferred"] = d
                extra += (f" deferred={d:.0f}/{length * m} node-rounds"
                          f" queue={float(metrics['queue_depth'][-1]):.1f}")
            if "comp_mean_gap" in metrics:
                gap = float(metrics["comp_mean_gap"][-1])
                chunk["comp_gap"] = gap
                extra += f" comp-gap={gap:.2e}"
            record["chunks"].append(chunk)
            print(f"[serve-train] step={k} m={m} loss={loss:.4f}{extra}"
                  f" ({(time.time() - t0) / max(k, 1):.2f}s/step)", flush=True)
            del metrics, info

        if k >= next_serve or k >= args.steps:
            ids = [(serve_cursor + i) % m for i in range(min(args.serve_nodes, m))]
            serve_cursor = (serve_cursor + args.serve_nodes) % m
            comp = None
            if args.serve_policy == "consensus":
                comp = _active_comp(bound, max(k - 1, 0))
            stats = serve.serve_round(bound.params_of(state), ids,
                                      policy=args.serve_policy, comp=comp)
            es = aux.events if (aux is not None and bound.paced) else None
            _serve_report(f"[serve-train] serve@{k}", stats, es)
            record["serves"].append({
                "k": k, "m": m, "policy": args.serve_policy,
                "comp": None if comp is None else comp.tolist(),
                "nodes": {i: {key: (v.shape if key == "tokens" else v) for key, v in s.items()}
                          for i, s in stats.items()},
                "latency_rounds": None if es is None else {
                    i: float(es.wait[i]) / max(int(es.served[i]), 1) for i in stats},
                "peak_bytes": _peak(device),
            })
            del stats
            next_serve += serve_every

        if args.ckpt_dir and k >= next_ckpt:
            payload = {"state": state}
            if aux is not None:
                payload["aux"] = aux
            tc = time.perf_counter()
            step_dir = save_checkpoint(args.ckpt_dir, k, payload)
            record["checkpoints"].append({"step": k, "seconds": time.perf_counter() - tc,
                                          "bytes": dir_bytes(step_dir)})
            del payload
            next_ckpt = (k // args.ckpt_every + 1) * args.ckpt_every

        while events and k >= events[0].step:
            ev = events.popleft()
            # future partition windows re-resolve against the current
            # topology at every rebind (check_membership_faults already
            # forbade membership changes inside an open window)
            future = tuple(w for w in windows if w.start >= k)
            rec = {"kind": ev.kind, "step": ev.step, "k": k, "m_before": m}

            if ev.kind == "partition":
                print(f"[serve-train] partition@{k}: graph split into {ev.n} components "
                      "(cross-component edges cut until heal)", flush=True)
                rec["monitor"] = _chaos_monitor(bound, k, f"partition@{ev.step}")
                comp = _active_comp(bound, k)
                rec["comp"] = None if comp is None else comp.tolist()
            elif ev.kind == "heal":
                comp = _active_comp(bound, max(ev.step - 1, 0))
                drift = (_comp_drift(bound, state, comp)
                         if comp is not None and comp.max() > 0 else 0.0)
                print(f"[serve-train] heal@{k}: partition re-merged; component mean "
                      f"drift {drift:.3e} handed back to gossip to reconcile", flush=True)
                rec["drift"] = drift
                rec["monitor"] = _chaos_monitor(bound, k, f"heal@{ev.step}")
            elif ev.n == 0:
                continue
            elif ev.kind == "leave":
                m_old = m
                # LIFO departure: the highest-id nodes retire, so state rows
                # stay contiguous and survivors keep their shards
                leavers = tuple(range(m - ev.n, m))
                pre_mean = _params_mean(bound, state)
                state = mb_mod.retire_state(state, topo, leavers)
                topo = mb_mod.shrunk_topology(topo, leavers)
                m = topo.m
                conf = _join_conformance(topo, m_old, kind="leave")
                old_events = aux.events if (aux is not None and bound.paced) else None
                bound = runner = aux = None  # the old m's tables go first
                bound, runner = _bind_for(args, topo, pacing, faults, grad_fn, device, future)
                make_batch = _make_batch_fn(args, cfg, m, device)
                if bound.carries_aux:
                    aux = bound.aux_init(state)
                    if bound.paced and old_events is not None:
                        # survivors keep their cumulative QPS and latency
                        aux = aux._replace(events=ev_mod.shrink_events(
                            old_events, list(range(m))))
                check = _leave_conformance(pre_mean, bound, state, m_old, m)
                del pre_mean
                print(f"[serve-train] leave@{k}: m={m_old}->{m} retired={list(leavers)} "
                      "deviation mass handed to neighbors (mean-preserving) conformance: "
                      f"doubly-stochastic={conf['rows'] and conf['cols']} "
                      f"mean-preserving={conf['mean']} (green)", flush=True)
                rec.update(retired=list(leavers), conformance=conf, leave_check=check)
            else:  # join
                m_old = m
                topo = mb_mod.grown_topology(topo, ev.n, degree=ev.degree, seed=args.seed)
                m = topo.m
                donors = mb_mod.default_donors(topo, m_old)
                conf = _join_conformance(topo, m_old)
                # checkpoint catch-up: the donors' rows from the newest
                # checkpoint when one exists, else from the live state
                source, src_tag = None, "live"
                if args.ckpt_dir:
                    last = latest_step(args.ckpt_dir)
                    if last is not None:
                        tmpl = {"state": state}
                        if aux is not None:
                            tmpl["aux"] = aux
                        tc = time.perf_counter()
                        try:
                            source = restore_checkpoint(args.ckpt_dir, tmpl, last)["state"]
                            src_tag = f"ckpt@{last}"
                            record["catch_up_restores"].append({
                                "step": last, "seconds": time.perf_counter() - tc,
                                "bytes": dir_bytes(os.path.join(args.ckpt_dir,
                                                                f"step_{last:09d}"))})
                        except (ValueError, CheckpointCorruptError):
                            source = None  # stale or mismatched checkpoint: live donors
                        del tmpl
                grown = mb_mod.expand_state(state, m_old, donors, source_state=source)
                old = [x for x in tree_leaves(state) if mb_mod._stacked(x, m_old)]
                new = [x for x in tree_leaves(grown) if mb_mod._stacked(x, m)]
                src = [x for x in tree_leaves(state if source is None else source)
                       if mb_mod._stacked(x, m_old)]
                dsel = torch.as_tensor(donors)
                rec["incumbents_untouched"] = _rows_equal([x[:m_old] for x in new], old)
                rec["joiners_equal_source"] = _rows_equal(
                    [x[m_old:] for x in new], [s[dsel.to(s.device)].to(x.device)
                                              for s, x in zip(src, new)])
                state = grown
                del grown, old, new, src, source
                old_events = aux.events if (aux is not None and bound.paced) else None
                bound = runner = aux = None  # the old m's tables go first
                bound, runner = _bind_for(args, topo, pacing, faults, grad_fn, device, future)
                make_batch = _make_batch_fn(args, cfg, m, device)
                if bound.carries_aux:
                    aux = bound.aux_init(state)
                    if bound.paced and old_events is not None:
                        # cumulative QPS and latency carry through the join;
                        # fresh rows for the new nodes
                        aux = aux._replace(events=ev_mod.expand_events(old_events, ev.n))
                print(f"[serve-train] join@{k}: m={m_old}->{m} donors={donors.tolist()} "
                      f"catch-up={src_tag} conformance: doubly-stochastic="
                      f"{conf['rows'] and conf['cols']} mean-preserving={conf['mean']} "
                      "(green)", flush=True)
                rec.update(donors=donors.tolist(), catch_up=src_tag, conformance=conf)
            rec["m_after"] = m
            record["events"].append(rec)
            if observe is not None:
                observe(rec, state)

    # run-level serving summary
    summary = {"deferred_node_rounds": deferred_total, "elapsed_s": time.time() - t0}
    if aux is not None and bound.paced:
        es = aux.events
        arrived, served = es.arrived.numpy(), es.served.numpy()
        lat = es.wait.numpy() / np.maximum(served, 1)
        qps = float(served.sum()) / max(summary["elapsed_s"], 1e-9)
        print(f"[serve-train] served {int(served.sum())}/{int(arrived.sum())} "
              f"requests ({qps:.1f} req/s wall) "
              f"mean latency={float(lat.mean()):.2f} rounds "
              f"deferred={deferred_total:.0f} node-rounds", flush=True)
        worst = int(np.argmax(lat))
        print("[serve-train] per-node latency (rounds): "
              + " ".join(f"{i}:{v:.1f}" for i, v in enumerate(lat))
              + f" (worst node {worst})", flush=True)
        summary.update(arrived=int(arrived.sum()), served=int(served.sum()),
                       mean_latency_rounds=float(lat.mean()),
                       node_latency_rounds=lat.tolist(), req_per_s=qps)
    record["summary"] = summary
    record["steps"] = k
    record["m"] = m
    print("[serve-train] done")
    return state, record


if __name__ == "__main__":
    main()
