#!/usr/bin/env python3
"""Where a tensor-core flash launch spends its clocks, step by step.

    PYTHONPATH=src python3 tools/flash_phases.py [SOURCE.cu]

Builds the flash source (default: the port's) with -DFLASH_PHASE_CLOCKS,
which makes every consumer warp of the tensor-core variant read the SM's
clock around each step of its main loop (``tc::PhaseClocks``): waiting for
the next K / V tile's copy, waiting for its turn at the tensor cores,
issuing the next S and this tile's P V (wgmma does not return before the
tensor cores take its last steps), waiting for S, the softmax, waiting for
P V and adding it into O, and the split of P into bf16 hi + lo.  For each
case below it runs one warm launch and one measured launch and prints, for
each consumer warpgroup, the tiles its main loop took (summed over the
blocks), the mean clocks a tile in each step, their sum, and the launch's
CUDA-event ms; then the card's name and power limit.  The
clock reads cost a few percent of the loop, so time the plain build
(`tools/flash_ab.py`), not this one.
"""
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))
sys.path.insert(0, HERE)

CASES = {  # name: (B, S, H, KV, D, window), the chip smoke's flash rows
    "row 4, path C": (8, 2048, 32, 32, 64, None),
    "row 4q, path I3": (8, 2048, 40, 8, 128, None),
    "row 4j, path J2": (8, 32768, 32, 32, 64, None),
    "row 4w, path J4a": (1, 524288, 32, 32, 64, 4096),
    "row 4L, qwen3-14b long_500k": (1, 524288, 40, 8, 128, 4096),
}
STEPS = ("tile_copy", "turn", "issue_s_pv", "s_wait", "softmax", "pv_wait_and_o", "split_p")


def main():
    import ctypes

    import torch
    from flash_ab import finish_build, start_build
    from repro_torch.kernels import _build

    src = sys.argv[1] if len(sys.argv) > 1 else str(_build.CSRC / "flash_attention.cu")
    if not torch.cuda.is_available():
        sys.exit(__doc__)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    out, proc = start_build(_build._nvcc(), [*_build.NVCC_FLAGS, "-DFLASH_PHASE_CLOCKS"], src,
                            tempfile.mkdtemp(prefix="flash_phases_"), "phases")
    fn, ptxas = finish_build(out, proc, src)
    print(json.dumps({"source": src, "ptxas": ptxas}), flush=True)
    read = ctypes.CDLL(out).flash_phase_clocks
    clocks = (ctypes.c_ulonglong * 16)()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for name, (b, s, h, kv, d, win) in CASES.items():
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
                   for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d)))
        o = torch.empty_like(q)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s, h, kv, d,
                win or 0, d ** -0.5, 1, 1, torch.cuda.current_stream().cuda_stream)
        for measured in (False, True):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            if fn(*args) != 0:
                sys.exit(f"{name}: launch failed")
            end.record()
            torch.cuda.synchronize()
            if read(clocks) != 0:
                sys.exit("reading the phase clocks failed")
        for wg in range(2):
            sums = list(clocks)[8 * wg: 8 * wg + 8]
            tiles = max(1, sums[7])
            per = {step: sums[i] / tiles for i, step in enumerate(STEPS)}
            print(json.dumps({"case": name, "shape": [b, s, h, kv, d], "window": win,
                              "warpgroup": wg, "loop_tiles": tiles // 4, "clocks_a_tile": per, "sum": sum(per.values()),
                              "ms": start.elapsed_time(end)}), flush=True)
        del q, k, v, o
        torch.cuda.empty_cache()
    print(smi.strip(), flush=True)


if __name__ == "__main__":
    main()
