#!/usr/bin/env python3
"""Time two versions of the SSD intra-chunk CUDA source on one card.

    PYTHONPATH=src python3 tools/ssd_ab.py OLD.cu NEW.cu

Builds both sources in parallel (each with `_build`'s nvcc flags and the
port's ``csrc/`` on the include path, after the source's own directory: a
parent's ``csrc/`` unpacked whole builds against its own headers), then,
for each row below, feeds both
the same bf16 inputs (drawn as `chip_smoke.check_ssd` draws them) through
their tensor-core variant.  Each side is held against the f32 plain version
of the same inputs: y within one floored bf16 ulp, the state within
1e-5 x max(1, its scale), the chip smoke's tolerances.  Row 6j, J4b's whole
launch (2^31 elements of x, 8.59 GB of state), is held on its last 64
chunks, whose state lies past 2^33 bytes from its start.  Then each side is
timed in ROUNDS rounds of turns (old, new, new, old), each turn the
CUDA-event median of its repetitions (the host's launch cost included),
and then once more under ``torch.profiler`` for the kernel's own duration
(``device_ms``, the median of its repetitions): at the small rows the
host's part is most of a call and moves by more than the kernels differ.
A row's line gives every turn's median a side, their median, least and
most, new over old of the medians and of the device times, the least time
the card could take (`chip_smoke.bound`, as `check_ssd` counts it) and
each side's share of it.  Prints one JSON line a source
(ptxas's registers, spills and warnings) and one a row, then the card's
name and power limit; exits non-zero if a side misses a tolerance.
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
sys.path.insert(0, os.path.join(HERE, "..", "src"))
sys.path.insert(0, os.path.join(HERE, ".."))
sys.path.insert(0, HERE)

ROWS = {  # name: (B, Nc, L, H, P, G, N)
    "row 5, path C": (8, 16, 128, 64, 64, 1, 64),
    "row 6, mamba2-1.3b": (8, 16, 128, 64, 64, 1, 128),
    "row 5h, path L2 zamba2 rank": (8, 16, 128, 32, 64, 1, 64),
    "tc-(1, 3, 64, 4, 64, 1, 64)": (1, 3, 64, 4, 64, 1, 64),
    "tc-(2, 2, 128, 8, 32, 2, 32)": (2, 2, 128, 8, 32, 2, 32),
    "tc-(1, 2, 112, 4, 128, 2, 48)": (1, 2, 112, 4, 128, 2, 48),
    "row 6j, path J4b": (1, 4096, 128, 64, 64, 1, 128),
}
HELD_CHUNKS = 64  # row 6j: the plain version of its last chunks only
ROUNDS = 5
TOL_ULPS = 1.0
TOL_STATE = 1e-5


def bind(out):
    fn = ctypes.CDLL(out).ssd_intra_chunk
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ptxas_lines(text):
    """ptxas's register, spill and performance-loss lines of each entry."""
    return [ln.split(": ", 1)[-1] for ln in text.splitlines()
            if "Used" in ln or "spill" in ln or "Performance Loss" in ln]


def inputs(gen, dev, b, nc, l, h, p, g, n):
    """check_ssd's draw: x, B, C normal in bf16; dt in [0.01, 0.21); cum
    the chunk's cumulative sum of dt times a negative rate a head."""
    import torch

    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    xc = rnd(b, nc, l, h, p).to(torch.bfloat16)
    dtc = torch.rand((b, nc, l, h), generator=gen, device=dev) * 0.2 + 0.01
    cum = torch.cumsum(dtc * -torch.exp(rnd(h) * 0.2), dim=2)
    bc, cc = rnd(b, nc, l, g, n).to(torch.bfloat16), rnd(b, nc, l, g, n).to(torch.bfloat16)
    return xc, dtc, cum, bc, cc


def main():
    import torch
    from chip_smoke import bound, device_ms, free, ulps_floored
    from flash_ab import start_build
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_scan.ref import ssd_intra_chunk_ref

    if len(sys.argv) != 3 or not torch.cuda.is_available():
        sys.exit(__doc__)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    tmp = tempfile.mkdtemp(prefix="ssd_ab_")
    started = {tag: start_build(_build._nvcc(), _build.NVCC_FLAGS, src, tmp, tag)
               for tag, src in zip(("old", "new"), sys.argv[1:])}
    fns = {}
    for (tag, (out, proc)), src in zip(started.items(), sys.argv[1:]):
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc failed for {src}:\n{stderr}")
        fns[tag] = bind(out)
        print(json.dumps({"source": tag, "path": src, "ptxas": ptxas_lines(stdout + stderr)}),
              flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    bad = []
    for name, (b, nc, l, h, p, g, n) in ROWS.items():
        xc, dtc, cum, bc, cc = inputs(gen, dev, b, nc, l, h, p, g, n)
        y = torch.empty_like(xc)
        st = torch.empty((b, nc, h, p, n), dtype=torch.float32, device=dev)

        def call(tag):
            rc = fns[tag](xc.data_ptr(), dtc.data_ptr(), cum.data_ptr(), bc.data_ptr(),
                          cc.data_ptr(), y.data_ptr(), st.data_ptr(), b, nc, l, h, p, g, n,
                          1, 1, torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                sys.exit(f"{tag} launch failed ({name}): cudaError {rc}")

        held = slice(nc - HELD_CHUNKS, None) if nc > HELD_CHUNKS else slice(None)
        y_r, st_r = ssd_intra_chunk_ref(xc[:, held].float(), dtc[:, held], cum[:, held],
                                        bc[:, held].float(), cc[:, held].float(), h // g)
        st_tol = TOL_STATE * max(1.0, st_r.abs().max().item())
        row = {"row": name, "shape": [b, nc, l, h, p, g, n],
               "held_chunks": nc if held == slice(None) else HELD_CHUNKS}
        for tag in ("old", "new"):
            y.fill_(float("nan"))
            st.fill_(float("nan"))
            call(tag)
            torch.cuda.synchronize()
            finite = bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
            row[f"{tag}_y_bf16_ulps_floored"] = ulps_floored(y[:, held], y_r)
            row[f"{tag}_state_max_abs_err"] = (st[:, held] - st_r).abs().max().item()
            row[f"{tag}_finite"] = finite
            if (row[f"{tag}_y_bf16_ulps_floored"] > TOL_ULPS
                    or row[f"{tag}_state_max_abs_err"] > st_tol or not finite):
                bad.append(f"{name} {tag}")
        row["state_tol"] = st_tol
        del y_r, st_r
        free()
        times = {"old": [], "new": []}
        reps = 10 if nc <= 64 else 3
        for tag in ("old", "new", "new", "old") * ROUNDS:
            call(tag)  # warm
            ms = []
            for _ in range(reps):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                call(tag)
                end.record()
                torch.cuda.synchronize()
                ms.append(start.elapsed_time(end))
            times[tag].append(statistics.median(ms))
        summary = {f"{tag}_{stat.__name__}_ms": stat(times[tag])
                   for tag in ("old", "new") for stat in (statistics.median, min, max)}
        for tag in ("old", "new"):
            summary[f"{tag}_device_ms"] = device_ms(lambda: call(tag), reps, name="ssd_tc_kernel")
        summary["device_new_over_old"] = summary["new_device_ms"] / summary["old_device_ms"]
        pairs = l * (l + 1) // 2
        flops = 2 * b * nc * h * (pairs * (n + p) + l * p * n)  # W, W x, state (causal half)
        bytes_ = (2 * xc.numel() + 2 * bc.numel()) * xc.element_size() \
            + 2 * dtc.numel() * 4 + st.numel() * 4
        bound_ms, bound_by = bound(bytes_, flops)
        print(json.dumps({**row, "old_ms": times["old"], "new_ms": times["new"], **summary,
                          "new_over_old": summary["new_median_ms"] / summary["old_median_ms"],
                          "bound_ms": bound_ms, "bound_by": bound_by,
                          "old_bound_share": bound_ms / summary["old_median_ms"],
                          "new_bound_share": bound_ms / summary["new_median_ms"],
                          "new_device_bound_share": bound_ms / summary["new_device_ms"]}),
              flush=True)
        del xc, dtc, cum, bc, cc, y, st
        free()
    print(smi.strip(), flush=True)
    if bad:
        sys.exit(f"beyond a tolerance of the f32 plain version: {bad}")


if __name__ == "__main__":
    main()
