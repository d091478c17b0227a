"""End-to-end driver on the PyTorch port: training and the paper's
replication machinery together, on the card.

    PYTHONPATH=src python examples/torch_train_with_replication.py
        [--steps 60] [--device cuda|cpu]

The counterpart of ``examples/train_with_replication.py``, with its flag
plus ``--device``.  What it shows, in one run:
  1. the dataset staged from a slow "STORE" site to two pod staging areas
     via the Figure-4 scheduler over real files (``LocalFSTransport`` and
     checksums);
  2. training on the pod-local copy with periodic checkpoints;
  3. every committed checkpoint replicated cross-site (POD1 + STORE);
  4. a simulated pod loss (the primary checkpoint tree destroyed) and
     recovery from the nearest replica.
It runs on the card (``cuda``, the default): every byte staged, copied,
re-read and restored is hashed by the integrity-hash kernel, and every
forward runs the flash-attention kernel.  ``--device cpu`` runs their plain
PyTorch versions instead.
"""
import argparse
import os
import shutil
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.checkpoint.ckpt import save_checkpoint
from repro_torch.checkpoint.replicate import CheckpointReplicator
from repro_torch.configs import get_config
from repro_torch.data.sharded import ShardedDataset, write_shards
from repro_torch.data.staging import StagingArea
from repro_torch.models.model import LM
from repro_torch.optim import adamw
from repro_torch.train.loop import TrainConfig, make_train_step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    cfg = get_config("smollm-135m").smoke()
    dev = args.device

    with tempfile.TemporaryDirectory() as td:
        # -- 1. stage the dataset from the slow store to both pods ----------
        staging = StagingArea(td, store="STORE", pods=("POD0", "POD1"),
                              device=dev)
        store_ds = os.path.join(td, "STORE", "datasets", "tokens")
        rng = np.random.default_rng(0)
        write_shards(store_ds, rng.integers(0, cfg.vocab_size, 200_000
                                            ).astype(np.int32), 4096)
        staging.register("datasets/tokens")
        steps = staging.run_until_staged()
        print(f"[stage] dataset staged to both pods in {steps} scheduler steps; "
              f"verified={staging.staged_ok('datasets/tokens')}")

        # -- 2. train from the pod-local copy -------------------------------
        data = ShardedDataset(staging.pod_path("POD0", "datasets/tokens"))
        model = LM(cfg, device=dev, seed=0, remat=False)
        model.requires_grad_(True)
        params = model.params()
        opt = adamw.init(params)
        tc = TrainConfig(steps=args.steps, batch_size=4, seq_len=128,
                         device=dev)
        step_fn = make_train_step(model, adamw.AdamWConfig(), tc)

        rep = CheckpointReplicator(td, primary="POD0",
                                   replicas=("POD1", "STORE"), device=dev)
        ckpt_root = os.path.join(rep.site_dir("POD0"), "ckpts")
        it = data.batches(tc.batch_size, tc.seq_len)
        losses = []
        for step in range(args.steps):
            batch_np, state = next(it)
            batch = {k: torch.from_numpy(v).to(model.device)
                     for k, v in batch_np.items()}
            params, opt, loss, _ = step_fn(opt, batch)
            losses.append(float(loss))
            if (step + 1) % 20 == 0:
                d = save_checkpoint(ckpt_root, step + 1,
                                    {"params": params, "opt": opt},
                                    device=dev)
                ok = rep.replicate(os.path.relpath(d, rep.site_dir("POD0")))
                print(f"[train] step {step+1} loss {float(loss):.4f} "
                      f"ckpt replicated={ok}")

        # -- 3. pod loss + recovery from replica -----------------------------
        shutil.rmtree(ckpt_root)
        print("[failure] POD0 checkpoint tree destroyed (simulated pod loss)")
        got = rep.restore_anywhere("ckpts", {"params": params, "opt": opt})
        assert got is not None
        step0, tree, _, site = got
        print(f"[recover] restored step {step0} from {site}; "
              f"loss trace {losses[0]:.3f} -> {losses[-1]:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
