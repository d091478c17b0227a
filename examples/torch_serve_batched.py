"""Batched serving on the PyTorch port: submit a stream of requests to the
wave-scheduled engine on the card.

    PYTHONPATH=src python examples/torch_serve_batched.py [--arch smollm-135m]
        [--requests 8] [--max-new 12] [--device cuda|cpu]

The counterpart of ``examples/serve_batched.py``, with its flags, its
reduced same-family config and its seeded prompts, plus ``--device``.  It
runs on the card (``cuda``, the default): every prefill runs the
flash-attention kernel in each attention layer and the selective-scan
kernel in each Mamba1 layer.  ``--device cpu`` runs their plain PyTorch
versions instead.  Weights come from the port's seeded init, so the tokens
differ from the reference's; the requests, waves and token counts do not.
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.serve.engine import Engine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=ARCH_IDS)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).smoke()
    eng = Engine(cfg, max_batch=args.batch, max_seq=128, device=args.device,
                 seed=0)

    rng = np.random.default_rng(0)
    t0 = time.time()
    for i in range(args.requests):
        plen = int(rng.integers(4, 24))
        if cfg.n_codebooks > 1:
            prompt = rng.integers(0, cfg.vocab_size, (plen, cfg.n_codebooks))
        else:
            prompt = rng.integers(0, cfg.vocab_size, plen)
        eng.submit(prompt, max_new_tokens=args.max_new)
    done = eng.run_to_completion()
    wall = time.time() - t0
    toks = sum(len(r.out_tokens) for r in done)
    print(f"arch={cfg.name}: served {len(done)} requests in {eng.waves} waves,"
          f" {toks} tokens in {wall:.1f}s ({toks/wall:.1f} tok/s on "
          f"{args.device})")
    for r in sorted(done, key=lambda r: r.rid)[:4]:
        print(f"  req {r.rid}: {r.out_tokens[:8]}{'...' if len(r.out_tokens) > 8 else ''}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
