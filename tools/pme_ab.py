#!/usr/bin/env python3
"""Time two versions of the PME-average CUDA source on one card.

    PYTHONPATH=src python3 tools/pme_ab.py OLD.cu NEW.cu

Builds both sources with `_build`'s nvcc flags, then, for each of the chip
smoke's PME-average rows (`rows`: its inputs, drawn as chip_smoke.py draws
them), feeds both the same inputs through ``pme_average_range``, checks
that the two outputs are bitwise equal, and
times each in ROUNDS rounds of turns (old, new, new, old).  A turn gives
two medians over its repetitions: ``ms``, CUDA events around one launch
of the C entry point (the host's launch cost included), and
``device_ms``, the kernel's own duration under ``torch.profiler``'s CUDA
activity.  A row's line gives every turn's medians a side, their median,
least and most, new over old of the medians, and the bound (bytes over
3.35 TB/s) with each side's share of it.  Prints one JSON line a row and
the card's name and power limit.  Each row's ``inputs_digest`` is the
one chip_smoke.py prints for the row: equal digests, the same inputs.
Compare versions only within one run: the card and its host differ
between runs.
"""
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.join(HERE, "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

ROUNDS = 5
W_CODE = {"torch.float32": 0, "torch.bfloat16": 1}


def build(nvcc, flags, src, out_dir, tag):
    from repro_torch.kernels import _build

    out = os.path.join(out_dir, tag, "kernel.so")  # one directory a side: dlopen keys on the path
    os.makedirs(os.path.dirname(out), exist_ok=True)
    res = subprocess.run([nvcc, *flags, "-I", str(_build.CSRC), "-o", out, src],
                         capture_output=True, text=True)
    if res.returncode != 0:
        sys.exit(f"nvcc failed for {src}:\n{res.stderr}")
    fn = ctypes.CDLL(out).pme_average_range
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong] + \
        [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ptxas = [ln.split(": ", 1)[-1] for ln in (res.stdout + res.stderr).splitlines()
             if "registers" in ln or "spill" in ln or "entry function" in ln]
    return fn, ptxas


def rows(dev):
    """(name, w, masks, a, (r0, r), reps): chip_smoke.py's PME-average rows
    1 and 1f (check_pme), 1r, 1rf, 1rk, 1rm and 1rn (check_pme_range), 1L and
    1h (check_lanes), their inputs drawn as those functions draw them, from
    the same seeds in the same order: the same tensors, so the same work
    (a denser selection gives more counts above 1, each a quotient)."""
    import torch

    import chip_smoke as cs
    from repro_torch.core import pme

    m, bf16, f32 = cs.M, torch.bfloat16, torch.float32
    exact = lambda g, n, p: pme.sample_coordinate_masks(g, m, n, round(p * n))  # noqa: E731
    ta = cs.f3_topology_arrays(dev)
    comm = torch.ones(m, dtype=torch.bool, device=dev)
    f3_sel = lambda g: pme.sample_neighbor_selection(g, ta.nbrs, ta.valid, ta.t, comm)  # noqa: E731

    g = torch.Generator(device=dev).manual_seed(1)  # check_pme
    for dtype in (f32, bf16):  # its small cases' draws
        for mm, n in ((7, 257), (37, 130)):
            torch.randn((mm, n), generator=g, device=dev)
            torch.rand((mm, n), generator=g, device=dev)
            torch.rand((mm, mm), generator=g, device=dev)
            torch.rand((mm, mm), generator=g, device=dev)
        torch.randn((9, 4096), generator=g, device=dev)
        torch.rand((9, 4096), generator=g, device=dev)
    w = torch.randn((m, cs.BIG_N), generator=g, device=dev).to(bf16)
    masks = exact(g, cs.BIG_N, 0.2)
    pairs = torch.zeros((m, m), device=dev)
    pairs[[1, 0, 3, 2], [0, 1, 2, 3]] = 1  # path B's selection
    yield "1", w, masks, pairs, (0, m), 5
    del w, masks
    a = f3_sel(g)
    w = torch.randn((m, cs.FC1_N), generator=g, device=dev)
    yield "1f", w, exact(g, cs.FC1_N, 0.3), a, (0, m), 50
    del w

    g = torch.Generator(device=dev).manual_seed(11)  # check_pme_range
    halves = ((1, 1), (2, 2))
    for name, n, dtype, p, reps, ranges in (
            ("1r", cs.BIG_N, bf16, 0.2, 5, halves), ("1rf", cs.FC1_N, f32, 0.3, 50, halves),
            ("1rk", cs.BIG_N, f32, 0.2, 5, ((0, m),)), ("1rm", cs.BIG_N // 2, bf16, 0.2, 5, ((0, m),)),
            ("1rn", cs.N_LEAF_N, bf16, 0.2, 5, ((0, 2), (2, 2)))):
        w = torch.randn((m, n), generator=g, device=dev).to(dtype)
        masks = exact(g, n, p)
        a = ((torch.rand((m, m), generator=g, device=dev) < 0.6)
             & ~torch.eye(m, dtype=torch.bool, device=dev)).float()
        a[:, 1] = 0
        for r0, r in ranges:
            key = f"{name}-r{r}" + (f"@{r0}" if name == "1rn" else "")
            yield key, w, masks, a, (r0, r), reps
        del w, masks

    g = torch.Generator(device=dev).manual_seed(5)  # check_lanes
    w = torch.randn((2, m, cs.BIG_N), generator=g, device=dev).to(bf16)
    masks = torch.stack([exact(g, cs.BIG_N, 0.2) for _ in range(2)])
    two = torch.zeros((2, m, m), device=dev)
    two[0, [1, 0, 3, 2], [0, 1, 2, 3]] = 1
    two[1, [2, 3, 0, 1], [0, 1, 2, 3]] = 1
    yield "1L", w, masks, two, (0, m), 5
    del w, masks
    n3 = 3 * 3 * 64 * 64
    a = torch.stack([f3_sel(g) for _ in range(cs.H_SEEDS)])
    w = torch.randn((cs.H_SEEDS, m, n3), generator=g, device=dev)
    masks = torch.stack([exact(g, n3, 0.3) for _ in range(cs.H_SEEDS)])
    yield "1h", w, masks, a, (0, m), 50


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build

    if len(sys.argv) != 3 or not torch.cuda.is_available():
        sys.exit(__doc__)
    import chip_smoke as cs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    tmp = tempfile.mkdtemp(prefix="pme_ab_")
    fns = {}
    for tag, src in zip(("old", "new"), sys.argv[1:]):
        fns[tag], ptxas = build(_build._nvcc(), _build.NVCC_FLAGS, src, tmp, tag)
        print(json.dumps({"source": tag, "path": src, "ptxas": ptxas}), flush=True)
    dev = torch.device("cuda")
    for name, w, masks, a, (r0, r), reps in rows(dev):
        lanes = w.shape[0] if w.dim() == 3 else 1
        m, n = w.shape[-2:]
        outs = {tag: w.new_empty(tuple(w.shape[:-2]) + (r, n)) for tag in fns}
        mask_code = 2 if masks.dtype == torch.bool else W_CODE[str(masks.dtype)]

        def call(tag):
            rc = fns[tag](w.data_ptr(), masks.data_ptr(), a.data_ptr(), outs[tag].data_ptr(),
                          m, n, lanes, r0, r, W_CODE[str(w.dtype)], mask_code,
                          torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                sys.exit(f"{tag} launch failed at row {name}: cudaError {rc}")

        call("old")
        call("new")
        torch.cuda.synchronize()
        equal = torch.equal(outs["old"], outs["new"])
        turns = ("old", "new", "new", "old") * ROUNDS
        ms = {"old": [], "new": []}
        for tag in turns:
            call(tag)  # warm
            times = []
            for _ in range(reps):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                call(tag)
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            ms[tag].append(statistics.median(times))
        device = {"old": [], "new": []}
        for tag in turns:  # a profiler session a turn
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    call(tag)
                torch.cuda.synchronize()
            got = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA and "pme_" in e.name]
            if not 1 <= len(got) <= reps:  # CUPTI may drop a record; never invents one
                sys.exit(f"row {name}: the profiler saw {len(got)} of {reps} kernels")
            device[tag].append(statistics.median(got))
        bytes_ = lanes * (m * n * (w.element_size() + masks.element_size())
                          + r * n * w.element_size() + m * m * 4)
        bound_ms = bytes_ / cs.HBM_BYTES_PER_S * 1e3
        line = {"row": name, "shape": list(w.shape), "receivers": [r0, r],
                "dtype": str(w.dtype), "mask": str(masks.dtype), "bitwise_equal": equal,
                "inputs_digest": cs.inputs_digest(w, masks, a), "bound_ms": bound_ms}
        for key, got in (("ms", ms), ("device_ms", device)):
            for tag in ("old", "new"):
                line[f"{tag}_{key}"] = got[tag]
                for stat in (statistics.median, min, max):
                    line[f"{tag}_{stat.__name__}_{key}"] = stat(got[tag])
                line[f"{tag}_share_{key}"] = bound_ms / line[f"{tag}_median_{key}"]
            line[f"new_over_old_{key}"] = (line[f"new_median_{key}"]
                                           / line[f"old_median_{key}"])
        print(json.dumps(line), flush=True)
        del outs
        torch.cuda.empty_cache()
    print(smi.strip(), flush=True)


if __name__ == "__main__":
    main()
