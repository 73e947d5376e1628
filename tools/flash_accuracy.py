#!/usr/bin/env python3
"""Error of flash-attention CUDA sources against an f64 reference, by length.

    PYTHONPATH=src python3 tools/flash_accuracy.py A.cu [B.cu ...]

Builds each source as `tools/flash_ab.py` does and feeds all of them the
same bf16 inputs (full causal, one batch row, 8 heads on 8 KV heads) at
each length below, through their tensor-core variant.  The last 512 query
rows of each output are held against causal attention computed in f64 on
the same inputs (`chip_smoke.causal_plain_rows`), beside three other
versions of those rows: the f64 result rounded to bf16 (the least error a
bf16 output can have), the plain version in f32 and SDPA in bf16.  Each
line gives, a version, the largest error in floored bf16 ulps (chip
smoke's measure: ulps of max(|want|, max|want| / 256)) and the largest
absolute error over the rows' RMS, then the card's name and power limit.
"""
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))
sys.path.insert(0, os.path.join(HERE, ".."))
sys.path.insert(0, HERE)

LENGTHS = (2048, 8192, 32768)
HEADS, ROWS = 8, 512


def main():
    import torch
    from chip_smoke import causal_plain_rows, ulps_floored
    from flash_ab import build
    from repro_torch.kernels import _build

    if len(sys.argv) < 2 or not torch.cuda.is_available():
        sys.exit(__doc__)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    tmp = tempfile.mkdtemp(prefix="flash_accuracy_")
    fns = {src: build(_build._nvcc(), _build.NVCC_FLAGS, src, tmp)[0] for src in sys.argv[1:]}
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for s in LENGTHS:
        b, h, d = 1, HEADS, 64
        q, k, v = (torch.randn((b, s, h, d), generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        lo = s - ROWS
        want = causal_plain_rows(q.double(), k.double(), v.double(), lo, 128)
        rms = want.pow(2).mean().sqrt().item()
        versions = {"f64 rounded to bf16": want.to(torch.bfloat16),
                    "plain f32": causal_plain_rows(q.float(), k.float(), v.float(), lo, 128),
                    "sdpa bf16": torch.nn.functional.scaled_dot_product_attention(
                        *(x.transpose(1, 2) for x in (q, k, v)), is_causal=True
                    ).transpose(1, 2)[:, lo:]}
        for src, fn in fns.items():
            out = torch.empty_like(q)
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h, h, d,
                    0, d ** -0.5, 1, 1, torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                sys.exit(f"{src}: launch failed, cudaError {rc}")
            versions[src] = out[:, lo:]
        torch.cuda.synchronize()
        for name, got in versions.items():
            print(json.dumps({
                "seq": s, "version": name,
                "bf16_ulps_floored": ulps_floored(got.double(), want),
                "max_abs_err_over_rms": (got.double() - want).abs().max().item() / rms}),
                flush=True)
        del q, k, v, want, versions
        torch.cuda.empty_cache()
    print(smi.strip(), flush=True)


if __name__ == "__main__":
    main()
