"""Decentralized federated training of a language model with PaME across
simulated nodes, on the PyTorch port.

    PYTHONPATH=src python examples/train_dfl_lm_torch.py               # on the card
    PYTHONPATH=src python examples/train_dfl_lm_torch.py --device cpu  # anywhere

The port of ``examples/train_dfl_lm.py``, with its flags: it reports the
per-round communication volume (Eq. 8) of one PME message at the chosen
transmission rate, then runs `repro_torch.launch.train` on the smoke
variant of the architecture.  ``--layers`` cuts the depth (the report
counts the cut model); ``--d-model`` is accepted as the JAX example
accepts it and, as there, not used (the trainer has no width flag).
Without ``--device cpu`` it runs on ``cuda`` and raises when no card is
present.
"""
import argparse

from repro_torch.configs import get_config
from repro_torch.core.pme import message_bits


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--p", type=float, default=0.2, help="transmission rate s/n")
    ap.add_argument("--algo", default="pame",
                    help="any registered algorithm (see repro_torch.core.algorithms)")
    ap.add_argument("--partition", default="flat", choices=["flat", "tree"],
                    help="PaME message format: flat vector vs per-leaf "
                         "segments (see repro_torch.launch.train --partition)")
    ap.add_argument("--layers", type=int, default=None, help="override depth")
    ap.add_argument("--d-model", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, "smoke")
    if args.layers is not None:
        cfg = cfg.replace(n_layers=args.layers)
    n_params = cfg.param_count()
    s = int(args.p * n_params)
    print(
        f"[example] {args.arch} (smoke: {n_params/1e6:.1f}M params), "
        f"m={args.nodes} nodes, s/n={args.p}"
    )
    print(
        f"[example] PME message: {message_bits(s, n_params, 16)/8e6:.2f} MB "
        f"(vs dense {16*n_params/8e6:.2f} MB bf16) per neighbor per round"
    )

    from repro_torch.launch import train as train_mod

    train_argv = [
        "--arch", args.arch, "--variant", "smoke", "--algo", args.algo,
        "--steps", str(args.steps), "--batch", str(args.batch),
        "--seq", str(args.seq), "--nodes", str(args.nodes),
        "--p", str(args.p), "--sigma0", "50", "--log-every", "10",
        "--device", args.device,
    ]
    if args.layers is not None:
        train_argv += ["--layers", str(args.layers)]
    if args.algo == "pame":
        train_argv += ["--partition", args.partition]
    return train_mod.main(train_argv)


if __name__ == "__main__":
    main()
