"""Quickstart on the PyTorch port: train an LM end to end on the card, with
checkpoint/restart.

    PYTHONPATH=src python examples/torch_quickstart.py [--arch smollm-135m]
        [--steps 200] [--preset full|small] [--device cuda|cpu]

The counterpart of ``examples/quickstart.py``, with its flags plus
``--device``.  It runs on the card (``cuda``, the default): every forward
runs the flash-attention or selective-scan kernel, and every checkpoint
byte is hashed by the integrity-hash kernel at its save and at its
restore.  ``--device cpu`` runs their plain PyTorch versions instead.
``--preset small`` (default) trains the reduced same-family config;
``--preset full`` the published one.  A failure is injected halfway (or at
``--fail-at``) to demonstrate restart from the last checkpoint.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.train.loop import TrainConfig, train


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--preset", default="small", choices=["small", "full"])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a failure at this step (demo of restart)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.preset == "small":
        cfg = cfg.smoke()
    fail_at = args.fail_at if args.fail_at is not None else args.steps // 2

    with tempfile.TemporaryDirectory() as td:
        tc = TrainConfig(steps=args.steps, batch_size=args.batch,
                         seq_len=args.seq, peak_lr=1e-3, warmup=20,
                         ckpt_every=max(10, args.steps // 8),
                         ckpt_dir=os.path.join(td, "ckpts"),
                         fail_at_step=fail_at, log_every=10,
                         device=args.device)
        res = train(cfg, tc)
        print(f"\narch={cfg.name} steps={res.final_step} "
              f"restarts={res.restarts} wall={res.wall_s:.1f}s")
        print(f"loss: {res.losses[0]:.4f} -> {res.losses[-1]:.4f} "
              f"({'improved' if res.losses[-1] < res.losses[0] else 'flat'})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
