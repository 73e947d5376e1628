#!/usr/bin/env python3
"""Time two versions of the flash-attention CUDA source on one card.

    PYTHONPATH=src python3 tools/flash_ab.py OLD.cu NEW.cu

Builds both sources in parallel (each with `_build`'s nvcc flags and the
port's ``csrc/`` on the include path, so either may include its headers),
then, for each case below, feeds both the same bf16 inputs through their
tensor-core variant.  The two designs need not round alike, so each side
is held against the f32 plain version of the same inputs within one
floored bf16 ulp (chip smoke's measure and tolerance; row 4j on its last
batch row, as `chip_smoke.check_flash_j2` holds it), and the line gives
the distance between the two outputs as well.  Then each side is timed in
ROUNDS rounds of turns (old, new, new, old), each turn the CUDA-event
median of its repetitions.  A case's line gives every turn's median a
side, their median, least and most, new over old of the medians, the
least time the card could take (`chip_smoke.bound`) and each side's share
of it, and SDPA's time where one call computes the case.  The cases are
the chip smoke's flash rows 4 (path C), 4q (path I3), 4h and 4qh (path
L2's ranks), 4j (path J2), 4w (path J4a) and 4L (qwen3-14b's long_500k).
Prints one JSON line a source (ptxas's registers, spills and warnings)
and one a case, then the card's name and power limit; exits non-zero if a
side misses the tolerance.  Compare versions only within one run: the card
and its host differ between runs.
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

CASES = {  # name: (B, S, H, KV, D, window)
    "row 4, path C": (8, 2048, 32, 32, 64, None),
    "row 4q, path I3": (8, 2048, 40, 8, 128, None),
    "row 4h, path L2 zamba2 rank": (8, 2048, 16, 16, 64, None),
    "row 4qh, path L2 qwen3 rank": (8, 2048, 20, 4, 128, None),
    "row 4j, path J2": (8, 32768, 32, 32, 64, None),
    "row 4w, path J4a": (1, 524288, 32, 32, 64, 4096),
    "row 4L, qwen3-14b long_500k": (1, 524288, 40, 8, 128, 4096),
}
ROUNDS = 5
TOL_ULPS = 1.0


def start_build(nvcc, flags, src, out_dir, tag):
    from repro_torch.kernels import _build

    out = os.path.join(out_dir, f"{tag}_{os.path.basename(src)}.so")
    proc = subprocess.Popen([nvcc, *flags, "-I", str(_build.CSRC), "-o", out, src],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return out, proc


def finish_build(out, proc, src):
    stdout, stderr = proc.communicate()
    if proc.returncode != 0:
        sys.exit(f"nvcc failed for {src}:\n{stderr}")
    fn = ctypes.CDLL(out).flash_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ptxas = [ln.split(": ", 1)[-1] for ln in (stdout + stderr).splitlines()
             if "registers" in ln or "spill" in ln or "Performance Loss" in ln]
    return fn, ptxas


def build(nvcc, flags, src, out_dir):
    """(the source's flash_attention entry point, ptxas's lines)."""
    return finish_build(*start_build(nvcc, flags, src, out_dir, "lib"), src)


def plain_f32(q, k, v, win):
    """(the rows held, the f32 plain version of those rows)."""
    import torch
    from chip_smoke import causal_plain_rows, windowed_plain
    from repro_torch.kernels.flash_attention.ref import attention_ref

    if win is not None:
        return slice(None), windowed_plain(q.float(), k.float(), v.float(), win)
    if q.shape[1] > 4096:  # the last batch row: [B, H, S, S] scores do not fit
        last = [x[-1:].float() for x in (q, k, v)]
        return slice(q.shape[0] - 1, None), causal_plain_rows(*last, 0, 512)
    torch.backends.cuda.matmul.allow_tf32 = False
    return slice(None), attention_ref(q.float(), k.float(), v.float(), win)


def main():
    import torch
    from chip_smoke import bound, chunked_max, free, ulps_floored
    from repro_torch.kernels import _build

    if len(sys.argv) != 3 or not torch.cuda.is_available():
        sys.exit(__doc__)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    tmp = tempfile.mkdtemp(prefix="flash_ab_")
    started = {tag: start_build(_build._nvcc(), _build.NVCC_FLAGS, src, tmp, tag)
               for tag, src in zip(("old", "new"), sys.argv[1:])}
    fns = {}
    for (tag, (out, proc)), src in zip(started.items(), sys.argv[1:]):
        fns[tag], ptxas = finish_build(out, proc, src)
        print(json.dumps({"source": tag, "path": src, "ptxas": ptxas}), flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bad = []
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

        outs = {tag: call(tag) for tag in ("old", "new")}
        rows, want = plain_f32(q, k, v, win)
        held = {f"{tag}_bf16_ulps_floored": ulps_floored(outs[tag][rows], want)
                for tag in ("old", "new")}
        del want
        free()
        absdiff = lambda a, c: (a.float() - c.float()).abs().max()  # noqa: E731
        held["new_vs_old_max_abs"] = chunked_max(absdiff, outs["new"], outs["old"])
        held["new_vs_old_bf16_ulps_floored"] = ulps_floored(outs["new"], outs["old"])
        bad += [f"{name} {tag}" for tag in ("old", "new")
                if held[f"{tag}_bf16_ulps_floored"] > TOL_ULPS
                or not torch.isfinite(outs[tag]).all()]
        del outs
        free()
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
        if win is None:
            from chip_smoke import time_ms

            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            summary["sdpa_ms"] = time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=kv != h), reps)
            del qt, kt, vt
            pairs = s * (s + 1) // 2
        else:
            from repro_torch.launch.dryrun import band_pairs

            pairs = band_pairs(s, win)
        flops = 4 * b * h * d * pairs  # q.k and p.v over the causal / window band
        bytes_ = (2 * q.numel() + 2 * k.numel()) * q.element_size()
        bound_ms, bound_by = bound(bytes_, flops)
        print(json.dumps({"case": name, "shape": [b, s, h, kv, d], "window": win, **held,
                          "old_ms": times["old"], "new_ms": times["new"], **summary,
                          "new_over_old": summary["new_median_ms"] / summary["old_median_ms"],
                          "bound_ms": bound_ms, "bound_by": bound_by,
                          "old_bound_share": bound_ms / summary["old_median_ms"],
                          "new_bound_share": bound_ms / summary["new_median_ms"]}),
              flush=True)
        del q, k, v
        free()
    print(smi.strip(), flush=True)
    if bad:
        sys.exit(f"beyond {TOL_ULPS} floored bf16 ulp of the f32 plain version: {bad}")


if __name__ == "__main__":
    main()
