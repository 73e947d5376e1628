#!/usr/bin/env python3
"""Chip smoke for the PyTorch port: drives its training path on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100.  Phases,
each printed as JSON lines; any failure raises and the script exits
non-zero without the final result line:

  1. the card's name and power limit (nvidia-smi); build both CUDA kernels
     from ``src/repro_torch/csrc`` (one nvcc per source, in parallel);
  2. each kernel against its plain PyTorch version on the card, on small
     odd shapes (isolated node, star hub, NaN-poisoned padding, more
     receivers than one tile) and at the path's largest leaf
     [4, 276,824,064]: max error, kernel / plain / library times (CUDA
     events, median) and the least time the card could take (bound);
  3. path A: the trainer CLI, stablelm-1.6b at full width and depth, PaME
     with the sparse exchange, 4 nodes, 3 steps — the gossip kernel must
     launch 11 times a step;
  4. path B: ``run_pame`` on the same model with ``PaMEConfig()``
     defaults (exact masks, dense exchange), 2 steps — the PME-average
     kernel must launch 10 times a step;
  5. one ``pame_step`` of each path with injected draws, through the
     kernels and through the plain versions: new params within one bf16 ulp;
  6. the kernel table line, then the result line.

Exits non-zero with no result when no CUDA device is present, or when the
port's sources are not beside this script.
"""
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

# H100 SXM data-sheet peaks (see PERF.md): HBM bytes/s, f32 (non-tensor) FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BIG_N = 24 * 2048 * 5632  # the largest leaf of stablelm-1.6b (w_gate / w_up / w_down)
M = 4
MODEL_ARGS = ["--arch", "stablelm-1.6b", "--variant", "full", "--algo", "pame",
              "--nodes", str(M), "--batch", "4", "--seq", "128"]


def emit(**kw):
    print(json.dumps(kw, sort_keys=True), flush=True)


def fail(msg):
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, reps, warmup=1):
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bf16_ulps(got, want):
    """max |got - want| in units of one bf16 ulp of want."""
    import torch

    w = want.float()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=2.0 ** -126))) - 7)
    return ((got.float() - w).abs() / ulp).max().item()


def free():
    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def check_gossip(dev):
    import torch
    from repro_torch.core import mixing
    from repro_torch.core.topology import build_topology
    from repro_torch.kernels.gossip.ops import gather_terms_kernel
    from repro_torch.kernels.gossip.ref import gather_terms_ref

    def case(name, nbrs, w, pad, xs, reps=0):
        terms = [(w, x) for x in xs]
        clean = torch.where(pad, torch.zeros_like(w), w) if pad is not None else w
        got = gather_terms_kernel(nbrs, terms, pad=pad)
        plain = gather_terms_ref(nbrs, [(clean, x) for x in xs])
        slots = mixing.gather_terms(nbrs, [(clean, x) for x in xs], impl="slots")
        torch.cuda.synchronize()
        err = max((g - p).abs().max().item() for g, p in zip(got, plain))
        scale = max(1.0, max(p.abs().max().item() for p in plain))
        same = all(torch.equal(g, s) for g, s in zip(got, slots))
        finite = all(torch.isfinite(g).all().item() for g in got)
        row = {"kernel": "gossip_gather", "case": name, "m": nbrs.shape[0],
               "n": xs[0][0].numel(), "k": nbrs.shape[1], "terms": len(xs),
               "max_abs_err": err, "tol": 1e-6 * scale, "equals_slots": same}
        del slots
        if not (err <= 1e-6 * scale and same and finite):
            emit(**row)
            fail(f"gossip kernel disagrees with its plain version ({name})")
        if reps:
            m, k = nbrs.shape
            n = xs[0][0].numel()
            row["ms"] = time_ms(lambda: gather_terms_kernel(nbrs, terms, pad=pad), reps)
            row["plain_ms"] = time_ms(lambda: gather_terms_ref(nbrs, terms, pad=pad), reps)
            row["library_ms"] = time_ms(
                lambda: mixing.gather_terms(nbrs, terms, pad=pad, impl="segsum"), reps)
            bytes_ = 2 * len(xs) * m * n * 4 + nbrs.numel() * 4 + w.numel() * 4
            flops = 2 * len(xs) * m * k * n
            row["bound_ms"] = max(bytes_ / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
            row["bound_by"] = "bytes" if bytes_ / HBM_BYTES_PER_S >= flops / F32_FLOPS else "operations"
        emit(**row)
        return row

    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev)

    def from_topo(kind, m, **kw):
        nbrs, w, is_self = (torch.as_tensor(x, device=dev) for x in
                            build_topology(kind, m, **kw).mixing_padded())
        pad = (nbrs == torch.arange(m, device=dev)[:, None]) & ~is_self
        return nbrs, torch.where(pad, torch.full_like(w, float("nan")), w), pad

    case("er-m7-n257", *from_topo("erdos_renyi", 7, p=0.5, seed=3), [rnd(7, 257), rnd(7, 257)])
    case("star-hub-nan-pad", *from_topo("star", 9), [rnd(9, 1000)])
    iso_nbrs = torch.tensor([[1, 0], [0, 1], [0, 2], [3, 3]], device=dev)
    iso_w = torch.tensor([[0.5, 0.5], [0.5, 0.5], [1.0, 0.0], [1.0, float("nan")]], device=dev)
    iso_pad = torch.tensor([[0, 0], [0, 0], [0, 0], [0, 1]], dtype=torch.bool, device=dev)
    x = rnd(4, 11)
    case("isolated-node", iso_nbrs, iso_w, iso_pad, [x])
    out = gather_terms_kernel(iso_nbrs, [(iso_w, x)], pad=iso_pad)[0]
    if not torch.equal(out[3], x[3]):
        fail("gossip kernel changed an isolated node's own row")
    case("ring-m40", *from_topo("ring", 40), [rnd(40, 130)])

    # the path's largest leaf: PME payload + count walks over path A's table
    topo = build_topology("erdos_renyi", M, p=0.5, seed=0)
    nbrs, valid = (torch.as_tensor(v, device=dev) for v in topo.neighbor_matrix_padded())
    sel = valid.clone()
    sel[0] = False  # a silent receiver, as between communication rounds
    mask = torch.rand((M, BIG_N), generator=g, device=dev) < 0.2
    payload = torch.randn((M, BIG_N), generator=g, device=dev).to(torch.bfloat16) * mask
    xs = [payload.float(), mask.float()]
    del payload, mask
    row = case("path-a-largest-leaf", nbrs, sel.float(), ~valid, xs, reps=5)
    del xs
    free()
    return row


def check_pme(dev):
    import torch
    from repro_torch.core import pme
    from repro_torch.kernels.pme_average.kernel import pme_average_cuda
    from repro_torch.kernels.pme_average.ref import pme_average_ref

    g = torch.Generator(device=dev).manual_seed(1)

    def case(name, w, masks, a, reps=0):
        got = pme_average_cuda(w, masks, a)
        plain = pme_average_ref(w, masks.to(w.dtype), a)
        torch.cuda.synchronize()
        err = (got.float() - plain.float()).abs().max().item()
        if w.dtype == torch.float32:
            scale = max(1.0, plain.abs().max().item())
            ok, tol = err <= 1e-6 * scale, 1e-6 * scale
        else:
            ulps = bf16_ulps(got, plain)
            ok, tol = ulps <= 1.0, "1 bf16 ulp"
        row = {"kernel": "pme_average", "case": name, "m": w.shape[0], "n": w.shape[1],
               "dtype": str(w.dtype), "mask": str(masks.dtype), "max_abs_err": err, "tol": tol}
        if not ok or not torch.isfinite(got).all():
            emit(**row)
            fail(f"pme_average kernel disagrees with its plain version ({name})")
        if reps:
            m, n = w.shape
            row["ms"] = time_ms(lambda: pme_average_cuda(w, masks, a), reps)
            row["plain_ms"] = time_ms(lambda: pme_average_ref(w, masks, a), reps)

            def library():  # the einsum form of repro/core/pme.py:158-161
                wm = torch.where(masks, w, 0)
                at = a.to(w.dtype)
                agg = torch.einsum("jn,ji->in", wm, at)
                cnt = torch.einsum("jn,ji->in", masks.to(w.dtype), at)
                return torch.where(cnt > 0, agg / cnt.clamp(min=1), w)

            row["library_ms"] = time_ms(library, reps)
            bytes_ = m * n * (2 * w.element_size() + masks.element_size()) + a.numel() * 4
            flops = 4 * m * m * n
            row["bound_ms"] = max(bytes_ / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
            row["bound_by"] = "bytes" if bytes_ / HBM_BYTES_PER_S >= flops / F32_FLOPS else "operations"
        emit(**row)
        return row

    def sel(m, p=0.5):
        a = ((torch.rand((m, m), generator=g, device=dev) < p)
             & ~torch.eye(m, dtype=torch.bool, device=dev)).float()
        a[:, 1] = 0  # receiver 1 isolated: keeps its own row
        return a

    for dtype in (torch.float32, torch.bfloat16):
        for name, m, n in (("m7-n257", 7, 257), ("m37-more-receivers-than-a-tile", 37, 130)):
            w = torch.randn((m, n), generator=g, device=dev).to(dtype)
            masks = torch.rand((m, n), generator=g, device=dev) < 0.3
            case(f"{name}-{dtype}", w, masks, sel(m))
            case(f"{name}-mask-in-w-type-{dtype}", w, masks.to(dtype), sel(m))
        star = torch.zeros((9, 9), device=dev)
        star[1:, 0] = 1  # hub 0 hears every leaf node
        star[0, 1:] = 1  # every leaf hears the hub
        w = torch.randn((9, 4096), generator=g, device=dev).to(dtype)
        case(f"star-hub-{dtype}", w, torch.rand((9, 4096), generator=g, device=dev) < 0.2, star)

    # the path's largest leaf: bf16 W, exact masks, path B's selection
    w = torch.randn((M, BIG_N), generator=g, device=dev).to(torch.bfloat16)
    masks = pme.sample_coordinate_masks(g, M, BIG_N, round(0.2 * BIG_N))
    a = torch.zeros((M, M), device=dev)
    a[[1, 0, 3, 2], [0, 1, 2, 3]] = 1
    row = case("path-b-largest-leaf", w, masks, a, reps=5)
    del w, masks
    free()
    return row


# ---------------------------------------------------------------------------
# phases 3-5: the training paths
# ---------------------------------------------------------------------------
def path_a():
    import torch
    from repro_torch.kernels.gossip.kernel import gossip_gather
    from repro_torch.kernels.pme_average.kernel import pme_average_cuda
    from repro_torch.launch import train

    steps = 3
    torch.cuda.reset_peak_memory_stats()
    gossip_gather.launches = pme_average_cuda.launches = 0
    out = train.main(MODEL_ARGS + ["--steps", str(steps), "--chunk", "1", "--device", "cuda"])
    launches = gossip_gather.launches
    row = {"phase": "path_a", "steps": out["steps"], "loss": out["loss"],
           "s_per_step": out["seconds"], "peak_bytes": torch.cuda.max_memory_allocated(),
           "gossip_launches": launches, "pme_average_launches": pme_average_cuda.launches}
    emit(**row)
    if launches != 11 * steps or not all(math.isfinite(x) for x in out["loss"]):
        fail("path A: expected 11 gossip launches a step and finite losses")
    free()
    return launches


def _task(dev):
    from repro_torch.configs import get_config
    from repro_torch.launch.train import make_lm_task

    cfg = get_config("stablelm-1.6b", "full")
    return make_lm_task(cfg, M, 4, 128, 0, "erdos_renyi", dev)


def path_b(dev):
    import torch
    from repro_torch.core import PaMEConfig, run_pame
    from repro_torch.kernels.gossip.kernel import gossip_gather
    from repro_torch.kernels.pme_average.kernel import pme_average_cuda

    steps = 2
    topo, params0, grad_fn, make_batch = _task(dev)
    torch.cuda.reset_peak_memory_stats()
    gossip_gather.launches = pme_average_cuda.launches = 0
    t0 = time.perf_counter()
    state, hist = run_pame(1, params0, M, grad_fn, make_batch, topo, PaMEConfig(),
                           num_steps=steps, chunk_size=1, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = pme_average_cuda.launches
    row = {"phase": "path_b", "steps": hist["steps_run"], "loss": hist["loss"],
           "s_per_step": secs / steps, "peak_bytes": torch.cuda.max_memory_allocated(),
           "pme_average_launches": launches, "gossip_launches": gossip_gather.launches,
           "depth": int(params0["groups"][0]["0_attn"]["ln"].shape[0])}
    emit(**row)
    if launches != 10 * steps or not all(math.isfinite(x) for x in hist["loss"]):
        fail("path B: expected 10 pme_average launches a step and finite losses")
    del state, params0
    free()
    return launches


def parity(dev):
    """One pame_step of each path with injected draws, through the kernels
    and through the plain versions (REPRO_TORCH_GOSSIP_IMPL=slots)."""
    import torch
    from repro_torch.core import pame, pme
    from repro_torch.core.mixing import ENV_VAR
    from repro_torch.tree import tree_flatten, tree_unflatten

    topo, params0, grad_fn, make_batch = _task(dev)
    g = torch.Generator(device=dev).manual_seed(7)
    leaves, treedef = tree_flatten(params0)
    # distinct node models, so the exchange averages different values
    stacked = [(x.unsqueeze(0) + 0.01 * torch.randn((M,) + tuple(x.shape), generator=g,
                                                   device=dev)).to(x.dtype) for x in leaves]
    del params0, leaves
    batch = make_batch(0)
    results = {}
    for name, cfg in (
        ("path_a", pame.PaMEConfig(nu=0.5, p=0.2, gamma=1.001, sigma0=20.0,
                                   mask_mode="bernoulli", mixing="sparse")),
        ("path_b", pame.PaMEConfig()),
    ):
        ta = pame.make_topology_arrays(topo, cfg, seed=0, device=dev)
        comm = torch.ones(M, dtype=torch.bool, device=dev)
        if cfg.mixing == "sparse":
            draws = {"sel": pme.sample_neighbor_selection_padded(g, ta.nbrs, ta.valid, ta.t, comm)}
        else:
            draws = {"a": pme.sample_neighbor_selection(g, ta.nbrs, ta.valid, ta.t, comm)}
        draws["masks"] = [
            pme.sample_coordinate_masks(g, M, x[0].numel(), max(1, round(cfg.p * x[0].numel())))
            if cfg.mask_mode == "exact" else pme.sample_bernoulli_masks(g, cfg.p, tuple(x.shape))
            for x in stacked
        ]
        state = pame.pame_init(3, tree_unflatten(treedef, stacked), M, cfg)
        outs = {}
        for impl in ("kernel", "slots"):
            if impl == "slots":
                os.environ[ENV_VAR] = "slots"
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                new, metrics = pame.pame_step(state, batch, grad_fn, ta, cfg, draws=draws)
                torch.cuda.synchronize()
                outs[impl + "_step_s"] = time.perf_counter() - t0
            finally:
                os.environ.pop(ENV_VAR, None)
            # park the result on the host while the other route runs
            outs[impl] = [x.cpu() for x in tree_flatten(new.params)[0]]
            outs[impl + "_loss"] = float(metrics["loss_mean"])
            del new, metrics
            free()
        ulps = max(bf16_ulps(a.to(dev), b.to(dev)) for a, b in zip(outs["kernel"], outs["slots"]))
        # the exchange alone (kernel route, same draws): the rest of a step
        # is the four nodes' forward + backward and the local update
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if cfg.mixing == "sparse":
            v_bar = pme.pme_average_pytree_padded(
                None, state.params, ta.nbrs, draws["sel"], cfg.p, mode=cfg.mask_mode,
                pad=~ta.valid, masks=draws["masks"])
        else:
            v_bar = pme.pme_average_pytree(None, state.params, draws["a"], cfg.p,
                                           mode=cfg.mask_mode, masks=draws["masks"])
        torch.cuda.synchronize()
        exchange_s = time.perf_counter() - t0
        del v_bar
        results[name] = {"max_bf16_ulps": ulps, "loss_kernel": outs["kernel_loss"],
                         "loss_plain": outs["slots_loss"], "step_s_kernel": outs["kernel_step_s"],
                         "step_s_plain": outs["slots_step_s"], "exchange_s_kernel": exchange_s}
        emit(phase="parity", path=name, **results[name])
        del draws, state, outs
        free()
        if ulps > 1.0:
            fail(f"{name}: kernel and plain routes differ by more than one bf16 ulp")
    return results


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs on the card only")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"the port's sources are not beside this script ({SRC})")
    sys.path.insert(0, SRC)
    os.environ.pop("REPRO_TORCH_GOSSIP_IMPL", None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    emit(phase="env", gpu=smi, torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0))
    build_s = _build.build()
    ptxas = {k: [ln.strip() for ln in v.splitlines() if "registers" in ln or "spill" in ln]
             for k, v in _build.BUILD_LOG.items()}
    emit(phase="build", seconds=build_s, ptxas=ptxas)

    t = time.perf_counter()
    gossip = check_gossip(dev)
    pme_row = check_pme(dev)
    emit(phase="kernels_checked", seconds=time.perf_counter() - t)

    t = time.perf_counter()
    gossip_launches = path_a()
    emit(phase="path_a_done", seconds=time.perf_counter() - t)
    t = time.perf_counter()
    pme_launches = path_b(dev)
    emit(phase="path_b_done", seconds=time.perf_counter() - t)
    t = time.perf_counter()
    parity(dev)
    emit(phase="parity_done", seconds=time.perf_counter() - t)

    def entry(name, source, replaces, launches, row):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "kernel_ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": row["library_ms"]}

    kernels = [
        entry("gossip_gather", "src/repro_torch/csrc/gossip_gather.cu",
              "src/repro/kernels/gossip/kernel.py:95", gossip_launches, gossip),
        entry("pme_average", "src/repro_torch/csrc/pme_average.cu",
              "src/repro/kernels/pme_average/kernel.py:46", pme_launches, pme_row),
    ]
    emit(phase="total", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
