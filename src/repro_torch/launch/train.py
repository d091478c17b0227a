"""Training launcher.

    python -m repro_torch.launch.train --arch smollm-135m --steps 200
        [--smoke/--full] [--batch 8] [--seq 128] [--ckpt-dir DIR]
        [--replicate-to POD1 STORE] [--microbatches N] [--remat]
        [--device cuda|cpu]

The flags are the JAX package's launcher's, plus ``--device`` (default
``cuda``, which raises without CUDA; ``cpu`` runs the kernels' plain
versions).  It drives the fault-tolerant loop on one device.
``--replicate-to`` turns on cross-site checkpoint replication via the
paper's scheduler (sites are sibling directories of the checkpoint root).
``--arch`` takes the ported patterns: the dense GQA models, the MoE models
(``qwen3-moe-30b-a3b``, ``deepseek-v2-lite-16b`` with MLA) and Mamba1; the
loop logs the MoE load-balancing loss (``aux``) beside the loss.
"""
from __future__ import annotations

import argparse
import os
import sys

from repro_torch.checkpoint.replicate import CheckpointReplicator
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.train.loop import TrainConfig, train


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="reduced same-family config (the default)")
    ap.add_argument("--full", dest="smoke", action="store_false",
                    help="the real architecture config")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--replicate-to", nargs="*", default=None,
                    help="site names to replicate checkpoints to")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    replicator = None
    ckpt_dir = args.ckpt_dir
    if args.replicate_to and ckpt_dir:
        root = os.path.dirname(os.path.abspath(ckpt_dir))
        primary = os.path.basename(os.path.abspath(ckpt_dir))
        replicator = CheckpointReplicator(
            root, primary=primary, replicas=tuple(args.replicate_to),
            device=args.device)
        ckpt_dir = os.path.join(replicator.site_dir(primary), "ckpts")

    tc = TrainConfig(steps=args.steps, batch_size=args.batch,
                     seq_len=args.seq, microbatches=args.microbatches,
                     peak_lr=args.lr, ckpt_every=args.ckpt_every,
                     ckpt_dir=ckpt_dir, replicator=replicator,
                     seed=args.seed, remat=args.remat, device=args.device)
    res = train(cfg, tc)
    print(f"done: arch={cfg.name} steps={res.final_step} "
          f"restarts={res.restarts} "
          f"loss {res.losses[0]:.4f}->{res.losses[-1]:.4f} "
          f"aux {res.aux[0]:.4f}->{res.aux[-1]:.4f} "
          f"wall={res.wall_s:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
