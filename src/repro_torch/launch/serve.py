"""Serving launcher: initialise a model and serve a batch of requests.

    python -m repro_torch.launch.serve --arch falcon-mamba-7b --requests 8
        [--ckpt-dir DIR] [--max-new 16] [--max-batch 4] [--max-seq 256]
        [--full] [--device cuda|cpu] [--seed 0]

The flags are the JAX package's launcher's, plus ``--device`` (default
``cuda``; ``cpu`` runs the kernels' plain versions).  Weights are drawn from
``--seed`` by the port's own init; ``--smoke`` (the default) serves the
reduced config, ``--full`` the published one.  ``--arch`` takes all ten
configs: smollm-135m, qwen3-14b, starcoder2-15b, qwen2-vl-7b,
musicgen-large, qwen3-moe-30b-a3b, deepseek-v2-lite-16b, falcon-mamba-7b,
gemma3-27b and zamba2-1.2b.  ``--ckpt-dir`` loads the
latest verified checkpoint into ``{"params": ...}`` (falling back to the
init where there is none), as the reference does: a checkpoint of either
package that holds params alone.  A training checkpoint (params and
optimizer state) has more leaves than that example tree and raises
``ValueError``, in the reference as here.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.checkpoint.ckpt import restore_checkpoint
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels.device import Device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import LM
from repro_torch.serve.engine import Engine, Request


def prompts(cfg: ModelConfig, n: int, max_seq: int, seed: int
            ) -> List[np.ndarray]:
    """``n`` prompts of 4 to max_seq/4 tokens ((plen, K) for K codebooks),
    drawn as the JAX package's launcher draws them."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        plen = int(rng.integers(4, max_seq // 4))
        shape = (plen, cfg.n_codebooks) if cfg.n_codebooks > 1 else plen
        out.append(rng.integers(0, cfg.vocab_size, shape))
    return out


def load_model(cfg: ModelConfig, device: Device = "cuda", seed: int = 0,
               ckpt_dir: Optional[str] = None) -> LM:
    """An ``LM`` of ``cfg`` on ``device`` with weights from ``seed``,
    replaced by the latest verified checkpoint's params under ``ckpt_dir``
    where there is one."""
    model = LM(cfg, device=device, seed=seed)
    if ckpt_dir:
        got = restore_checkpoint(ckpt_dir, {"params": model.params()},
                                 device=device)
        if got is not None:
            step, tree, d = got
            model.load_params(tree["params"])
            print(f"loaded checkpoint step {step} from {d}")
    return model


def serve(cfg: ModelConfig, requests: int = 8, max_new: int = 16,
          max_batch: int = 4, max_seq: int = 256, device: Device = "cuda",
          seed: int = 0, engine: Optional[Engine] = None
          ) -> Tuple[Engine, List[Request], float]:
    """Serve ``requests`` seeded prompts through ``engine`` (a new one on
    ``device`` with weights from ``seed`` by default); (engine, finished
    requests, wall seconds)."""
    eng = engine if engine is not None else Engine(
        cfg, max_batch=max_batch, max_seq=max_seq, device=device, seed=seed)
    t0 = time.perf_counter()
    for prompt in prompts(cfg, requests, eng.S, seed):
        eng.submit(prompt, max_new_tokens=max_new)
    done = eng.run_to_completion()
    return eng, done, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    model = load_model(cfg, args.device, args.seed, args.ckpt_dir)
    eng = Engine(cfg, model=model, max_batch=args.max_batch,
                 max_seq=args.max_seq)
    eng, done, wall = serve(cfg, args.requests, args.max_new, engine=eng,
                            seed=args.seed)
    toks = sum(len(r.out_tokens) for r in done)
    print(f"served {len(done)} requests / {toks} tokens in {wall:.1f}s "
          f"({eng.waves} waves, {toks / max(wall, 1e-9):.1f} tok/s, "
          f"{args.device})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
