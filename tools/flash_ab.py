#!/usr/bin/env python3
"""Time two versions of the flash-attention CUDA source on one card.

    PYTHONPATH=src python3 tools/flash_ab.py OLD.cu NEW.cu

Builds both sources (each with `_build`'s nvcc flags and the port's
``csrc/`` on the include path, so either may include ``mma_bf16.cuh``),
then, for each case below, feeds both the same bf16 inputs through their
tensor-core variant, checks that the two outputs are bitwise equal, and
times each in ROUNDS rounds of turns (old, new, new, old), each turn the
CUDA-event median of its repetitions.  A case's line gives every turn's
median a side, their median, least and most, and new over old of the
medians.  The cases
are the chip smoke's rows 4 (path C), 4q (path I3) and 4w (path J4a's
window at 524,288 tokens).  Prints one JSON line a case and the card's
name and power limit.  Compare versions only within one run: the card and
its host differ between runs.
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

CASES = {  # name: (B, S, H, KV, D, window)
    "row 4, path C": (8, 2048, 32, 32, 64, None),
    "row 4q, path I3": (8, 2048, 40, 8, 128, None),
    "row 4w, path J4a": (1, 524288, 32, 32, 64, 4096),
}
ROUNDS = 5


def build(nvcc, flags, src, out_dir):
    from repro_torch.kernels import _build

    out = os.path.join(out_dir, os.path.basename(src) + ".so")
    res = subprocess.run([nvcc, *flags, "-I", str(_build.CSRC), "-o", out, src],
                         capture_output=True, text=True)
    if res.returncode != 0:
        sys.exit(f"nvcc failed for {src}:\n{res.stderr}")
    fn = ctypes.CDLL(out).flash_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ptxas = [ln.split(": ", 1)[-1] for ln in (res.stdout + res.stderr).splitlines()
             if "registers" in ln or "spill" in ln]
    return fn, ptxas


def main():
    import torch
    from repro_torch.kernels import _build

    if len(sys.argv) != 3 or not torch.cuda.is_available():
        sys.exit(__doc__)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    tmp = tempfile.mkdtemp(prefix="flash_ab_")
    fns = {}
    for tag, src in zip(("old", "new"), sys.argv[1:]):
        fns[tag], ptxas = build(_build._nvcc(), _build.NVCC_FLAGS, src, tmp)
        print(json.dumps({"source": tag, "path": src, "ptxas": ptxas}), flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for name, (b, s, h, kv, d, win) in CASES.items():
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
                   for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d)))

        def call(tag):
            out = torch.empty_like(q)
            rc = fns[tag](q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h,
                          kv, d, win or 0, d ** -0.5, 1, 1,
                          torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                sys.exit(f"{tag} launch failed: cudaError {rc}")
            return out

        equal = torch.equal(call("old"), call("new"))
        times = {"old": [], "new": []}
        reps = 10 if s <= 4096 else 3
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
        print(json.dumps({"case": name, "shape": [b, s, h, kv, d], "window": win,
                          "bitwise_equal": equal, "old_ms": times["old"],
                          "new_ms": times["new"], **summary,
                          "new_over_old": summary["new_median_ms"] / summary["old_median_ms"]}),
              flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    print(smi.strip(), flush=True)


if __name__ == "__main__":
    main()
