#!/usr/bin/env python3
"""Where a tensor-core SSD launch spends its clocks, step by step.

    PYTHONPATH=src python3 tools/ssd_phases.py [SOURCE.cu]

Builds the SSD intra-chunk source (default: the port's) with
-DSSD_PHASE_CLOCKS, which makes every warp that computes in the
tensor-core variant read the SM's clock around each step of its work on a
head (``tc::PhaseClocks``): waiting for the copies of x (and, where they
are not already there, B and C), the product S = C B^T, W and its split
into bf16 hi + lo, W x, the state (x dec)^T B with x dec's split, and the
stores of y and the state, the head's dt, cum and decay (the wait for
their loads included), and the warpgroup's barrier before the head's x.  For each case below it runs one warm launch and
one measured launch and prints, for each group of warps the source sums
separately (its consumer warpgroups), the warp-heads counted and the mean
clocks a warp spends on a head in each step, their sum, and the launch's
CUDA-event ms; then the card's name and power limit.  The clock reads cost
a few percent, so time the plain build (`tools/ssd_ab.py`), not this one.
"""
import ctypes
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))
sys.path.insert(0, os.path.join(HERE, ".."))
sys.path.insert(0, HERE)

CASES = {  # name: (B, Nc, L, H, P, G, N), rows of tools/ssd_ab.py
    "row 5, path C": (8, 16, 128, 64, 64, 1, 64),
    "row 6, mamba2-1.3b": (8, 16, 128, 64, 64, 1, 128),
    "row 5h, path L2 zamba2 rank": (8, 16, 128, 32, 64, 1, 64),
}
STEPS = ("copy_wait", "s", "w_and_split", "w_x", "state", "stores", "dt_cum", "barrier")
SLOTS = len(STEPS) + 1  # a group's clocks, then its warp-heads
GROUPS = 4  # room for the groups of warps a source sums apart


def main():
    import torch
    from flash_ab import start_build
    from repro_torch.kernels import _build
    from ssd_ab import bind, inputs, ptxas_lines

    src = sys.argv[1] if len(sys.argv) > 1 else str(_build.CSRC / "ssd_intra_chunk.cu")
    if not torch.cuda.is_available():
        sys.exit(__doc__)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    out, proc = start_build(_build._nvcc(), [*_build.NVCC_FLAGS, "-DSSD_PHASE_CLOCKS"], src,
                            tempfile.mkdtemp(prefix="ssd_phases_"), "phases")
    stdout, stderr = proc.communicate()
    if proc.returncode != 0:
        sys.exit(f"nvcc failed for {src}:\n{stderr}")
    fn = bind(out)
    print(json.dumps({"source": src, "ptxas": ptxas_lines(stdout + stderr)}), flush=True)
    read = ctypes.CDLL(out).ssd_phase_clocks
    clocks = (ctypes.c_ulonglong * (SLOTS * GROUPS))()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    for name, (b, nc, l, h, p, g, n) in CASES.items():
        xc, dtc, cum, bc, cc = inputs(gen, dev, b, nc, l, h, p, g, n)
        y = torch.empty_like(xc)
        st = torch.empty((b, nc, h, p, n), dtype=torch.float32, device=dev)
        args = (xc.data_ptr(), dtc.data_ptr(), cum.data_ptr(), bc.data_ptr(), cc.data_ptr(),
                y.data_ptr(), st.data_ptr(), b, nc, l, h, p, g, n, 1, 1,
                torch.cuda.current_stream().cuda_stream)
        for _ in range(2):  # warm, then measured
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            if fn(*args) != 0:
                sys.exit(f"{name}: launch failed")
            end.record()
            torch.cuda.synchronize()
            if read(clocks) != 0:
                sys.exit("reading the phase clocks failed")
        for grp in range(GROUPS):
            sums = list(clocks)[SLOTS * grp: SLOTS * grp + SLOTS]
            if sums[-1] == 0:
                continue
            per = {step: sums[i] / sums[-1] for i, step in enumerate(STEPS)}
            print(json.dumps({"case": name, "shape": [b, nc, l, h, p, g, n], "group": grp,
                              "warp_heads": sums[-1], "clocks_a_head": per,
                              "sum": sum(per.values()), "ms": start.elapsed_time(end)}),
                  flush=True)
        del xc, dtc, cum, bc, cc, y, st
        torch.cuda.empty_cache()
    print(smi.strip(), flush=True)


if __name__ == "__main__":
    main()
