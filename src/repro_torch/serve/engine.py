"""Batched serving engine (wave-scheduled static batching).

A port of the JAX package's ``serve/engine.py``.  Requests are admitted in
waves of up to B: prompts are left-padded to a common length (bucketed to
16, 32, 64, ...), prefilled in one batched call, then decoded greedily one
token a step for the whole wave; finished requests leave the wave, and when
the wave drains the next one is admitted.  The model runs on ``device``
(default ``"cuda"``); ``"cpu"`` runs the kernels' plain versions.

``stats`` keeps the host-clock seconds of each prefill and each decode step,
each ending when its next tokens reach the host (which waits for the
device), for the serving metrics: prefill time per wave, decode time per
token.  They are the durations of the engine's coarse spans
(``repro_torch.obs.spans``): ``engine.prefill`` from the cache's creation
to the wave's first tokens on the host, and ``engine.decode`` for a step
(attrs ``live``, the sequences that take a token, and ``t``, its
position), with the child ``lm.decode_step`` around the call into the
model, which returns once the step's work is enqueued; its ``graph`` attr
is the path the model reports (``LM.decode_path``): "capture" or "replay"
where the step is a CUDA graph, else "eager"; its ``mamba1_layers`` attr is
the model's count of Mamba1 mixers (``LM.mamba1_layers``), each of which a
step runs once.

A config with K codebooks (musicgen) takes prompts (T, K), decodes a
(B, 1, K) token a step, and returns each step's K ids as a list, as the
reference does.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.kernels.device import Device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import LM
from repro_torch.obs import spans


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # (T,) or (T, K) int32
    max_new_tokens: int = 16
    out_tokens: List = field(default_factory=list)
    done: bool = False


def _bucket(n: int) -> int:
    b = 16
    while b < n:
        b *= 2
    return b


class Engine:
    def __init__(self, cfg: ModelConfig, model: Optional[LM] = None,
                 max_batch: int = 4, max_seq: int = 256,
                 device: Device = "cuda", seed: int = 0):
        """Serve ``model``, or an ``LM`` of ``cfg`` on ``device`` with weights
        drawn from ``seed`` when none is given."""
        self.cfg = cfg
        self.model = model if model is not None else LM(cfg, device=device,
                                                         seed=seed)
        self.B = max_batch
        self.S = max_seq
        self._queue: List[Request] = []
        self._next_rid = 0
        self.waves = 0
        self.stats: Dict[str, List[float]] = {"prefill_s": [], "decode_s": []}

    # ------------------------------------------------------------------- api
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(Request(rid, np.asarray(prompt, np.int32),
                                   max_new_tokens))
        return rid

    def run_to_completion(self) -> List[Request]:
        done: List[Request] = []
        while self._queue:
            done.extend(self._run_wave())
        return done

    # ------------------------------------------------------------------ wave
    def _greedy(self, logits: torch.Tensor) -> np.ndarray:
        return torch.argmax(logits, dim=-1).reshape(self.B, -1).cpu().numpy()

    def _run_wave(self) -> List[Request]:
        wave = [self._queue.pop(0)
                for _ in range(min(self.B, len(self._queue)))]
        self.waves += 1
        B = self.B
        lens = [r.prompt.shape[0] for r in wave]
        T = _bucket(max(lens))
        multik = self.cfg.n_codebooks > 1
        book = (self.cfg.n_codebooks,) if multik else ()
        toks = np.zeros((B, T, *book), np.int32)
        for i, r in enumerate(wave):
            toks[i, T - lens[i]:T] = r.prompt     # left-pad
        with spans.span("engine.prefill", wave=self.waves, B=B, T=T,
                        prompt_tokens=sum(lens)) as sp:
            cache = self.model.init_cache(B, self.S)
            logits, cache = self.model.prefill(torch.from_numpy(toks), cache)
            nxt = self._greedy(logits)
        self.stats["prefill_s"].append(sp.seconds)
        t = T
        active = {i: r for i, r in enumerate(wave)}
        for i, r in active.items():
            r.out_tokens.append(_tok_out(nxt[i], multik))
        finished: List[Request] = []
        while active and t < self.S - 1:
            cur = np.zeros((B, 1, *book), np.int32)
            for i, r in active.items():
                cur[i, 0] = r.out_tokens[-1]
            with spans.span("engine.decode", live=len(active), t=t) as sp:
                tok = torch.from_numpy(cur)
                # the call alone: the last step's state is freed after it
                with spans.span("lm.decode_step", mamba1_layers=self.model
                                .mamba1_layers) as inner:
                    out = self.model.decode_step(cache, tok, t)
                    inner.attrs["graph"] = self.model.decode_path
                lg, cache = out
                nxt = self._greedy(lg)
            self.stats["decode_s"].append(sp.seconds)
            t += 1
            for i, r in list(active.items()):
                r.out_tokens.append(_tok_out(nxt[i], multik))
                if len(r.out_tokens) >= r.max_new_tokens:
                    r.done = True
                    finished.append(r)
                    del active[i]
        for r in active.values():
            r.done = True
            finished.append(r)
        return finished


def _tok_out(row: np.ndarray, multik: bool):
    return [int(v) for v in row] if multik else int(row[0])
