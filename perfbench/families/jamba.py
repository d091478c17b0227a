"""Jamba (AI21's ``JambaConfig`` keys): a stack of pre-norm layers, each a
mixer, Mamba1 or GQA attention with no positional encoding, and an FFN, a
gated MLP or a mixture of experts, by the config's four period and offset
keys (``plan``).  The Mamba1 mixer normalises dt, B and C after
``x_proj``; the router is a softmax over the experts whose top-k weights
are not renormalised, and no routing is dropped.  The dt initialisation is
the file's ``assumed``."""
from __future__ import annotations

from types import SimpleNamespace
from typing import List, Mapping, Tuple

from perfbench.weights import F32, ones, w, zeros


def plan(cfg: Mapping) -> List[Tuple[str, str]]:
    """(mixer, ffn) of each layer: "attn" where ``i % attn_layer_period ==
    attn_layer_offset``, else "mamba1"; "moe" where ``i %
    expert_layer_period == expert_layer_offset``, else "mlp"."""
    def at(i, key):
        return i % cfg[f"{key}_layer_period"] == cfg[f"{key}_layer_offset"]
    return [("attn" if at(i, "attn") else "mamba1",
             "moe" if at(i, "expert") else "mlp")
            for i in range(cfg["num_hidden_layers"])]


def sizes(cfg: Mapping) -> SimpleNamespace:
    d, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    return SimpleNamespace(
        family="jamba", d=d, n_layers=cfg["num_hidden_layers"],
        heads=heads, kv_heads=cfg["num_key_value_heads"], hd=d // heads,
        d_in=cfg["mamba_expand"] * d, n=cfg["mamba_d_state"],
        d_conv=cfg["mamba_d_conv"], r=cfg["mamba_dt_rank"],
        experts=cfg["num_experts"], top_k=cfg["num_experts_per_tok"],
        ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
        eps=cfg["rms_norm_eps"], plan=plan(cfg),
        dt_min=cfg["assumed"]["time_step_min"],
        dt_max=cfg["assumed"]["time_step_max"])


def specs(s: SimpleNamespace) -> dict:
    def mamba():
        return {"in_x": w(s.d, s.d_in), "in_z": w(s.d, s.d_in),
                "conv_w": w(s.d_conv, s.d_in, std=s.d_conv ** -0.5),
                "conv_b": zeros(s.d_in),
                "x_proj": w(s.d_in, s.r + 2 * s.n), "dt_proj": w(s.r, s.d_in),
                "dt_bias": ((s.d_in,), F32, ("dt_bias", s.dt_min, s.dt_max)),
                "A_log": ((s.d_in, s.n), F32, ("a_log", s.n)),
                "D": ones(s.d_in, F32), "out_proj": w(s.d_in, s.d),
                "dt_norm": {"scale": ones(s.r)},
                "b_norm": {"scale": ones(s.n)},
                "c_norm": {"scale": ones(s.n)}}

    def attn():
        return {"wq": w(s.d, s.heads * s.hd), "wk": w(s.d, s.kv_heads * s.hd),
                "wv": w(s.d, s.kv_heads * s.hd), "wo": w(s.heads * s.hd, s.d)}

    def layer(mixer, ffn):
        b = {"ln1": {"scale": ones(s.d)}, "ln2": {"scale": ones(s.d)}}
        if mixer == "attn":
            b["attn"] = attn()
        else:
            b["ssm"] = mamba()
        E = s.experts
        b[ffn] = {"router": w(s.d, E, dtype=F32), "w_gate": w(E, s.d, s.ff),
                  "w_up": w(E, s.d, s.ff), "w_down": w(E, s.ff, s.d)} \
            if ffn == "moe" else {"w_gate": w(s.d, s.ff),
                                  "w_up": w(s.d, s.ff),
                                  "w_down": w(s.ff, s.d)}
        return b
    return {"embed": w(s.vocab, s.d, std=1.0),
            "final_norm": {"scale": ones(s.d)}, "lm_head": w(s.d, s.vocab),
            "blocks": [layer(*p) for p in s.plan]}


def model_config(cfg: Mapping):
    from repro_torch.models.config import (MixedConfig, MoEConfig,
                                           ScheduleConfig, SSMNormConfig)
    d, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    if cfg["mamba_dt_rank"] != max(1, d // 16):
        raise ValueError("the port's Mamba1 takes dt rank d // 16, "
                         f"not {cfg['mamba_dt_rank']}")
    if cfg["mamba_proj_bias"] or not cfg["mamba_conv_bias"] \
            or cfg["hidden_act"] != "silu":
        raise ValueError("the port's Mamba1 has a conv bias, no projection "
                         "bias, and SiLU")
    return MixedConfig(
        name=cfg["name"], family="hybrid", n_layers=cfg["num_hidden_layers"],
        d_model=d, n_heads=heads, n_kv_heads=cfg["num_key_value_heads"],
        head_dim=d // heads, d_ff=cfg["intermediate_size"],
        vocab_size=cfg["vocab_size"], norm_eps=cfg["rms_norm_eps"],
        tie_embeddings=cfg["tie_word_embeddings"],
        ssm=SSMNormConfig(version=1, d_state=cfg["mamba_d_state"],
                          d_conv=cfg["mamba_d_conv"],
                          expand=cfg["mamba_expand"]),
        moe=MoEConfig(n_routed=cfg["num_experts"],
                      top_k=cfg["num_experts_per_tok"], n_shared=0,
                      d_ff_expert=cfg["intermediate_size"],
                      capacity_factor=None, router_norm_topk=False),
        schedule=ScheduleConfig(
            attn_period=cfg["attn_layer_period"],
            attn_offset=cfg["attn_layer_offset"],
            expert_period=cfg["expert_layer_period"],
            expert_offset=cfg["expert_layer_offset"]))
