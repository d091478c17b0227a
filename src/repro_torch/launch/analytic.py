"""Analytic FLOP/byte model of the JAX package's *lowered* program.

A copy of the JAX package's ``launch/analytic.py``: the same arithmetic,
so ``analytic_cost`` returns the reference's numbers for every (arch,
shape, mode).  It models the computation the reference's model code
lowers, including the baseline inefficiencies its own perf loop attacks:

  * chunked attention computes full-S scores per query chunk (no causal
    block skipping) -> attention MACs = T×S, not T×S/2;
  * score tensors round-trip memory (logits + softmax weights materialize,
    2× f32 passes);
  * full per-layer remat in training recomputes the forward during
    backward;
  * attention chunks are additionally rematted (one extra attention
    forward).

The port's attention (the flash-attention kernel, B3) skips the key blocks
that the causal mask or the window hides and keeps its scores on chip, so
its attention work is about half the T×S this model charges.

All numbers are GLOBAL (whole step, all devices).  MACs are converted to
FLOPs with the ×2 convention.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import moe_capacity


@dataclass
class Cost:
    flops: float = 0.0          # total FLOPs
    hbm_bytes: float = 0.0      # total HBM bytes moved

    def __iadd__(self, other):
        self.flops += other.flops
        self.hbm_bytes += other.hbm_bytes
        return self


def _attn_flops_per_layer(cfg: ModelConfig, tokens: int, S: int,
                          decode: bool) -> float:
    """QKVO projections + scores/PV for one attention layer (fwd, FLOPs)."""
    d, hd = cfg.d_model, cfg.head_dim
    H, K = cfg.n_heads, cfg.n_kv_heads
    if cfg.mla is not None:
        m = cfg.mla
        qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
        proj = (d * H * qk_hd            # W_q
                + d * (m.kv_lora_rank + m.qk_rope_head_dim)   # W_dkv + rope k
                + m.kv_lora_rank * H * (m.qk_nope_head_dim + m.v_head_dim)
                + H * m.v_head_dim * d)  # W_o
        score = S * H * (qk_hd + m.v_head_dim)       # per query token
        return 2.0 * tokens * (proj + score)
    proj = d * hd * (2 * H + 2 * K)
    score = S * H * hd * 2                            # QK^T + PV per query
    return 2.0 * tokens * (proj + score)


def _mlp_flops_per_layer(d: int, ff: int, tokens: int) -> float:
    return 2.0 * tokens * 3 * d * ff


def _moe_flops_per_layer(cfg: ModelConfig, tokens: int) -> float:
    m = cfg.moe
    d = cfg.d_model
    C = moe_capacity(m, tokens)
    routed = 2.0 * m.n_routed * C * 3 * d * m.d_ff_expert
    shared = 2.0 * tokens * 3 * d * (m.n_shared * m.d_ff_expert)
    router = 2.0 * tokens * d * m.n_routed
    return routed + shared + router


def _ssm_flops_per_layer(cfg: ModelConfig, tokens: int, decode: bool) -> float:
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    if s.version == 1:
        dtr = max(1, d // 16)
        proj = 2 * d * 2 * d_in + 2 * d_in * (dtr + 2 * s.d_state) \
            + 2 * dtr * d_in + 2 * d_in * d
        scan = 8.0 * d_in * s.d_state        # exp + 2 mul + add per (ch, state)
        conv = 2.0 * s.d_conv * d_in
        return tokens * (proj + scan + conv)
    H = d_in // s.headdim
    P, G, N = s.headdim, s.n_groups, s.d_state
    proj = 2 * d * (2 * d_in + 2 * G * N + H) + 2 * d_in * d
    conv = 2.0 * s.d_conv * (d_in + 2 * G * N)
    if decode:
        ssd = 6.0 * H * P * N                 # single-step state update
    else:
        Lc = s.chunk
        # per token: CB^T row (Lc*N per head) + M·x (Lc*P) + state in/out (2NP)
        ssd = 2.0 * H * (Lc * N + Lc * P + 2 * N * P)
    return tokens * (proj + conv + ssd)


def _head_flops(cfg: ModelConfig, tokens: int) -> float:
    return 2.0 * tokens * cfg.d_model * cfg.vocab_size * cfg.n_codebooks


def analytic_cost(cfg: ModelConfig, global_batch: int, seq_len: int,
                  mode: str) -> Dict[str, float]:
    """Returns global flops/bytes for one step of the given mode."""
    from repro_torch.models.config import param_count
    total_p, active_p = param_count(cfg)
    decode = mode == "decode"
    tokens = global_batch * (1 if decode else seq_len)
    S = seq_len                       # context length (cache len for decode)

    kinds = cfg.layer_kinds()
    fwd = Cost()
    attn_fwd = 0.0
    for i, k in enumerate(kinds):
        if k in ("attn", "local"):
            eff_S = min(cfg.sliding_window, S) if (
                k == "local" and cfg.sliding_window) else S
            f = _attn_flops_per_layer(cfg, tokens, eff_S, decode)
            attn_fwd += f
            fwd.flops += f
            if cfg.moe is not None and i >= cfg.moe.first_dense_layers:
                fwd.flops += _moe_flops_per_layer(cfg, tokens)
            elif cfg.moe is not None:
                fwd.flops += _mlp_flops_per_layer(cfg.d_model,
                                                  cfg.moe.d_ff_dense, tokens)
            else:
                fwd.flops += _mlp_flops_per_layer(cfg.d_model, cfg.d_ff, tokens)
        elif k == "ssm":
            fwd.flops += _ssm_flops_per_layer(cfg, tokens, decode)
    if cfg.hybrid is not None:
        n_sites = cfg.n_layers // cfg.hybrid.shared_attn_every
        f = _attn_flops_per_layer(cfg, tokens, S, decode) * n_sites
        attn_fwd += f
        fwd.flops += f
        fwd.flops += _mlp_flops_per_layer(cfg.d_model, cfg.d_ff, tokens) * n_sites
    fwd.flops += _head_flops(cfg, tokens)

    # ----- bytes, forward ----------------------------------------------------
    dtype_b = 2                      # bf16 params/activations
    n_layer_passes = len(kinds) + (0 if cfg.hybrid is None else
                                   cfg.n_layers // cfg.hybrid.shared_attn_every)
    act_pass = 12.0 * tokens * cfg.d_model * dtype_b      # r/w per layer
    fwd.hbm_bytes += total_p * dtype_b                     # weights read once
    fwd.hbm_bytes += n_layer_passes * act_pass
    # baseline score materialization (logits + weights, f32, r+w each)
    if not decode:
        score_elems = 0.0
        for k in kinds:
            if k in ("attn", "local") and cfg.n_heads:
                eff_S = min(cfg.sliding_window, S) if (
                    k == "local" and cfg.sliding_window) else S
                score_elems += float(tokens) * eff_S * cfg.n_heads
        if cfg.hybrid is not None:
            score_elems += (float(tokens) * S * cfg.n_heads
                            * (cfg.n_layers // cfg.hybrid.shared_attn_every))
        fwd.hbm_bytes += score_elems * 4.0 * 4.0   # logits w + r, weights w + r
    if decode:
        fwd.hbm_bytes += _cache_bytes(cfg, global_batch, S)  # read full cache
    fwd.hbm_bytes += tokens * cfg.vocab_size * cfg.n_codebooks * dtype_b  # logits

    out = {"fwd_flops": fwd.flops, "attn_fwd_flops": attn_fwd,
           "fwd_bytes": fwd.hbm_bytes}
    if mode == "train":
        # bwd = 2×fwd; full per-layer remat = +1×fwd; chunked-attention extra
        # remat = +1×attention-fwd; optimizer ~10 flops/param
        flops = 4.0 * fwd.flops + attn_fwd + 10.0 * total_p
        bytes_ = 3.0 * fwd.hbm_bytes            # fwd + remat-fwd + bwd traffic
        bytes_ += total_p * (4 + 4 + 4) * 2     # master/m/v f32 read+write
        bytes_ += total_p * dtype_b * 2         # grads + new bf16 params
        out.update({"flops": flops, "bytes": bytes_})
    else:
        out.update({"flops": fwd.flops, "bytes": fwd.hbm_bytes})
    out["model_flops"] = 6.0 * active_p * tokens if mode == "train" \
        else 2.0 * active_p * tokens
    return out


def _cache_bytes(cfg: ModelConfig, batch: int, S: int) -> float:
    """Bytes of KV/SSM state read per decode step (global)."""
    kinds = cfg.layer_kinds()
    total = 0.0
    for k in kinds:
        if k in ("attn", "local"):
            eff_S = min(cfg.sliding_window, S) if (
                k == "local" and cfg.sliding_window) else S
            if cfg.mla is not None:
                m = cfg.mla
                total += batch * eff_S * (m.kv_lora_rank
                                          + m.qk_rope_head_dim) * 2
            else:
                total += batch * eff_S * cfg.n_kv_heads * cfg.head_dim * 2 * 2
        elif k == "ssm":
            s = cfg.ssm
            d_in = s.expand * cfg.d_model
            total += batch * d_in * s.d_state * 4
    if cfg.hybrid is not None:
        n_sites = cfg.n_layers // cfg.hybrid.shared_attn_every
        total += n_sites * batch * S * cfg.n_kv_heads * cfg.head_dim * 2 * 2
    return total
