"""Serving example on the PyTorch port: prefill a batch of prompts, then
batched greedy decode with ring-buffer KV caches.

    PYTHONPATH=src python examples/serve_decode_torch.py                # on the card
    PYTHONPATH=src python examples/serve_decode_torch.py --device cpu \\
        --prompt-len 32 --gen 16 --batch 4 [--window 16]

The port of ``examples/serve_decode.py``, with its flags plus ``--device``
(default ``cuda``; without a card it raises instead of falling back).
``--arch`` defaults to stablelm-1.6b rather than the JAX example's
qwen3-14b, because the port does not carry qwen3-14b yet (it carries
stablelm-1.6b, zamba2-1.2b and mamba2-1.3b); the smoke variant is served,
as in the JAX example.  Tokens stay on the device until the last step, and
the timings synchronise the card first.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import decode_step, init_params, prefill
from repro_torch.serve.serving import decode_greedy


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--window", type=int, default=None,
                    help="sliding window (ring-buffer cache of this size)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where it runs (default cuda; raises without a card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, "smoke")
    if args.window:
        cfg = cfg.replace(window=args.window)
    params = init_params(0, cfg, device=dev)
    rng = np.random.default_rng(0)
    capacity = args.window or (args.prompt_len + args.gen)
    prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))
    batch = {"tokens": torch.as_tensor(prompts.astype(np.int32), device=dev)}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    with torch.inference_mode():
        sync()
        t0 = time.perf_counter()
        logits, caches = prefill(params, cfg, batch, capacity)
        sync()
        t_prefill = time.perf_counter() - t0
        tok = torch.argmax(logits, -1).to(torch.int32)
        # tokens accumulate on the device and move to the host once
        t0 = time.perf_counter()
        out = decode_greedy(lambda p, t, pos, c: decode_step(p, cfg, t, pos, c),
                            params, tok, caches, args.prompt_len, args.gen)
        gen = out.cpu().numpy()
        t_decode = time.perf_counter() - t0

    n_decoded = args.batch * (args.gen - 1)
    print(f"[serve] arch={cfg.name} batch={args.batch} window={args.window} device={dev}")
    print(f"[serve] prefill {args.prompt_len} toks: {t_prefill*1e3:.1f} ms")
    print(f"[serve] decode {args.gen-1} steps: {t_decode*1e3:.1f} ms "
          f"({t_decode/(args.gen-1)*1e3:.1f} ms/tok, "
          f"{n_decoded/max(t_decode, 1e-9):.1f} tokens/s)")
    print(f"[serve] generated ids (seq 0): {gen[0].tolist()}")
    return {"tokens": gen, "prefill_ms": t_prefill * 1e3, "decode_ms": t_decode * 1e3}


if __name__ == "__main__":
    main()
