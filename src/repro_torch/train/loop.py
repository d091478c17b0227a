"""Fault-tolerant training loop.

Wires together: model (any of the ten configs), AdamW, data pipeline
(synthetic or sharded files), periodic checkpointing with integrity
manifests, optional cross-site checkpoint replication (the paper's
scheduler), restart-from-manifest, and failure injection for tests.  A port
of the JAX package's ``train/loop.py`` on ``TrainConfig.device`` (default
``"cuda"``; ``"cpu"`` runs the kernels' plain versions).

Designed so that a process crash at ANY step resumes bit-compatibly:
  * params/opt state from the last committed checkpoint (verified);
  * data pipeline from its serialized IterState (exact delivery state);
  * step counter from the checkpoint metadata.

The reference's jitted step is a Python function here: the forward runs
the kernels (flash attention, the selective scan), autograd runs their
eager backward, and the new bf16 params from AdamW are written back into
the model (``LM.load_params``).  The step's metrics carry the loss's
``aux`` term (the MoE load-balancing loss, 0 without MoE) beside AdamW's,
and the loop logs and keeps it beside the loss.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import torch

from repro_torch import tree as T
from repro_torch.checkpoint.ckpt import restore_checkpoint, save_checkpoint
from repro_torch.checkpoint.replicate import CheckpointReplicator
from repro_torch.data.synthetic import for_model
from repro_torch.kernels.device import Device, require_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import LM
from repro_torch.optim import adamw
from repro_torch.optim.schedule import warmup_cosine


@dataclass
class TrainConfig:
    steps: int = 100
    batch_size: int = 8
    seq_len: int = 128
    microbatches: int = 1            # gradient accumulation factor
    peak_lr: float = 3e-4
    warmup: int = 20
    ckpt_every: int = 25
    ckpt_dir: Optional[str] = None
    replicator: Optional[CheckpointReplicator] = None
    seed: int = 0
    log_every: int = 10
    fail_at_step: Optional[int] = None      # fault injection (tests)
    remat: bool = False
    device: Device = "cuda"


@dataclass
class TrainResult:
    losses: List[float]
    final_step: int
    restarts: int
    restored_from: Optional[str] = None
    wall_s: float = 0.0
    aux: List[float] = field(default_factory=list)


def make_train_step(model: LM, opt_cfg: adamw.AdamWConfig,
                    train_cfg: TrainConfig):
    """Builds the (opt_state, batch) -> (params, opt_state, loss, metrics)
    step with microbatch gradient accumulation.  The params are the model's
    own: the step writes AdamW's new bf16 params into it and returns them
    as a tree.  ``metrics`` holds AdamW's and the loss's ``aux`` (the mean
    over microbatches)."""
    mb = train_cfg.microbatches
    leaves = T.leaves(model.parameter_tree())

    def grads_of(batch):
        # a batch of frontend embeddings leaves the token table unused: its
        # gradient is zero, as jax.grad gives it
        loss, metrics = model.loss_fn(batch)
        return loss, metrics["aux"], torch.autograd.grad(
            loss, leaves, allow_unused=True, materialize_grads=True)

    def step(opt_state, batch):
        if mb == 1:
            loss, aux, flat = grads_of(batch)
        else:
            parts = {k: v.reshape((mb, v.shape[0] // mb) + v.shape[1:])
                     for k, v in batch.items()}
            acc = [torch.zeros(p.shape, dtype=torch.float32,
                               device=p.device) for p in leaves]
            loss = aux = 0.0
            for i in range(mb):
                l, a, g = grads_of({k: v[i] for k, v in parts.items()})
                acc = [x + gi for x, gi in zip(acc, g)]
                loss = loss + l.detach()
                aux = aux + a.detach()
            flat = [x / mb for x in acc]
            loss, aux = loss / mb, aux / mb
        grads = T.unflatten(model.parameter_tree(), list(flat))
        del flat
        lr = warmup_cosine(opt_state.step, train_cfg.peak_lr,
                           train_cfg.warmup, train_cfg.steps)
        params, opt_state, opt_metrics = adamw.update(
            grads, opt_state, lr, opt_cfg)
        del grads
        model.load_params(params)
        return params, opt_state, loss.detach(), dict(
            opt_metrics, aux=aux.detach())

    return step


class SimulatedFailure(RuntimeError):
    pass


def train(cfg: ModelConfig, tc: TrainConfig,
          data_iter_factory: Optional[Callable] = None) -> TrainResult:
    """Run training with automatic restart on (injected) failures."""
    t0 = time.time()
    dev = require_device(tc.device)
    losses: List[float] = []
    auxes: List[float] = []
    restarts = 0
    restored_from = None
    fail_at = tc.fail_at_step

    while True:
        try:
            model = LM(cfg, device=dev, seed=tc.seed, remat=tc.remat)
            model.requires_grad_(True)
            params = model.params()
            opt_state = adamw.init(params)
            start_step = 0

            if tc.ckpt_dir:
                got = restore_checkpoint(
                    tc.ckpt_dir, {"params": params, "opt": opt_state},
                    device=dev)
                if got is not None:
                    start_step, tree, d = got
                    model.load_params(tree["params"])
                    opt_state = tree["opt"]
                    restored_from = d

            data = (data_iter_factory(cfg, tc) if data_iter_factory
                    else for_model(cfg, tc.batch_size, tc.seq_len, tc.seed))
            step_fn = make_train_step(model, adamw.AdamWConfig(), tc)

            for step in range(start_step, tc.steps):
                batch_np = data.batch_at(step)
                batch = {k: torch.from_numpy(v).to(dev)
                         for k, v in batch_np.items()}
                if fail_at is not None and step == fail_at:
                    fail_at = None   # fail exactly once
                    raise SimulatedFailure(f"injected failure at step {step}")
                params, opt_state, loss, metrics = step_fn(opt_state, batch)
                losses.append(float(loss))
                auxes.append(float(metrics["aux"]))
                if tc.log_every and step % tc.log_every == 0:
                    print(f"[train] step {step} loss {losses[-1]:.4f} "
                          f"aux {auxes[-1]:.4f}")
                next_step = step + 1
                if tc.ckpt_dir and next_step % tc.ckpt_every == 0:
                    d = save_checkpoint(
                        tc.ckpt_dir, next_step,
                        {"params": params, "opt": opt_state}, device=dev)
                    if tc.replicator is not None:
                        rel = os.path.relpath(
                            d, tc.replicator.site_dir(tc.replicator.primary))
                        tc.replicator.replicate(rel)
            return TrainResult(losses, tc.steps, restarts, restored_from,
                               time.time() - t0, auxes)
        except SimulatedFailure as e:
            print(f"[train] FAILURE: {e}; restarting from checkpoint")
            restarts += 1
            if not tc.ckpt_dir:
                raise
