"""NVIDIA Nemotron-H with experts (the HF ``nemotron_h`` keys): a stack of
pre-norm blocks, each one sublayer, by the characters of
``hybrid_override_pattern``: "M" Mamba2, "*" GQA attention with no
positional encoding, "E" a mixture of experts.  Mamba2 has
``mamba_num_heads`` heads of ``mamba_head_dim`` (its inner width, not
``expand`` times d), ``n_groups`` groups of B and C, and a gated RMSNorm a
group.  The router is a sigmoid whose top k are chosen with a per-expert
selection bias and weighted by the unbiased scores, renormalised and
scaled; the experts and the shared one are non-gated relu² MLPs.  The
initialisation is the file's ``assumed``."""
from __future__ import annotations

from types import SimpleNamespace
from typing import List, Mapping

from perfbench.weights import F32, ones, w, zeros

KINDS = {"M": "mamba2", "*": "attn", "E": "moe"}


def plan(cfg: Mapping) -> List[str]:
    """Each block's kind, "mamba2", "attn" or "moe": the first
    ``num_hidden_layers`` characters of the pattern."""
    pattern = cfg["hybrid_override_pattern"]
    n = cfg["num_hidden_layers"]
    if len(pattern) < n or set(pattern) - set(KINDS):
        raise ValueError(f"{n} blocks from the pattern {pattern!r}")
    return [KINDS[c] for c in pattern[:n]]


def sizes(cfg: Mapping) -> SimpleNamespace:
    H, P = cfg["mamba_num_heads"], cfg["mamba_head_dim"]
    return SimpleNamespace(
        family="nemotron_h", d=cfg["hidden_size"],
        n_layers=cfg["num_hidden_layers"], plan=plan(cfg),
        heads=cfg["num_attention_heads"], kv_heads=cfg["num_key_value_heads"],
        hd=cfg["head_dim"], mamba_heads=H, mamba_hd=P, d_in=H * P,
        groups=cfg["n_groups"], n=cfg["ssm_state_size"],
        d_conv=cfg["conv_kernel"], chunk=cfg["chunk_size"],
        experts=cfg["n_routed_experts"], top_k=cfg["num_experts_per_tok"],
        ff=cfg["moe_intermediate_size"],
        ff_shared=cfg["moe_shared_expert_intermediate_size"],
        shared=cfg["n_shared_experts"], norm_topk=cfg["norm_topk_prob"],
        scale=cfg["routed_scaling_factor"], vocab=cfg["vocab_size"],
        eps=cfg["norm_eps"], dt_min=cfg["time_step_min"],
        dt_max=cfg["time_step_max"],
        bias_std=cfg["assumed"]["score_bias_std"],
        down_scale=cfg["assumed"]["routed_down_scale"])


def specs(s: SimpleNamespace) -> dict:
    def mamba2():
        GN, conv = s.groups * s.n, s.d_conv ** -0.5
        return {"in_z": w(s.d, s.d_in), "in_x": w(s.d, s.d_in),
                "in_B": w(s.d, GN), "in_C": w(s.d, GN),
                "in_dt": w(s.d, s.mamba_heads),
                "conv_x_w": w(s.d_conv, s.d_in, std=conv),
                "conv_x_b": zeros(s.d_in),
                "conv_B_w": w(s.d_conv, GN, std=conv), "conv_B_b": zeros(GN),
                "conv_C_w": w(s.d_conv, GN, std=conv), "conv_C_b": zeros(GN),
                "dt_bias": ((s.mamba_heads,), F32,
                            ("dt_bias", s.dt_min, s.dt_max)),
                "A_log": ((s.mamba_heads,), F32, ("a_log", s.mamba_heads)),
                "D": ones(s.mamba_heads, F32),
                "norm": {"scale": ones(s.d_in)},
                "out_proj": w(s.d_in, s.d)}

    def attn():
        return {"wq": w(s.d, s.heads * s.hd), "wk": w(s.d, s.kv_heads * s.hd),
                "wv": w(s.d, s.kv_heads * s.hd), "wo": w(s.heads * s.hd, s.d)}

    def moe():
        E = s.experts
        return {"router": w(s.d, E, dtype=F32),
                "score_bias": ((E,), F32, ("normal", s.bias_std)),
                "w_up": w(E, s.d, s.ff),
                "w_down": w(E, s.ff, s.d, std=s.down_scale * s.ff ** -0.5),
                "shared": {"w_up": w(s.d, s.ff_shared),
                           "w_down": w(s.ff_shared, s.d)}}
    make = {"mamba2": ("ssm", mamba2), "attn": ("attn", attn),
            "moe": ("moe", moe)}

    def block(kind):
        key, sub = make[kind]
        return {"ln": {"scale": ones(s.d)}, key: sub()}
    return {"embed": w(s.vocab, s.d, std=1.0),
            "final_norm": {"scale": ones(s.d)}, "lm_head": w(s.d, s.vocab),
            "blocks": [block(k) for k in s.plan]}


def model_config(cfg: Mapping):
    from repro_torch.models.config import (Mamba2HeadsConfig, MixedConfig,
                                           SigmoidMoEConfig)
    if (cfg["mamba_hidden_act"], cfg["mlp_hidden_act"]) != ("silu", "relu2"):
        raise ValueError("the port's Mamba2 takes SiLU and its experts "
                         "relu²")
    if not cfg["use_conv_bias"] or cfg["use_bias"] \
            or cfg["mamba_proj_bias"] or cfg["attention_bias"] \
            or cfg["mlp_bias"]:
        raise ValueError("the port's blocks have a conv bias and no other")
    if (cfg["n_group"], cfg["topk_group"]) != (1, 1):
        raise ValueError("the port's sigmoid router has no group stage")
    n = cfg["num_hidden_layers"]
    return MixedConfig(
        name=cfg["name"], family="hybrid", n_layers=n,
        d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        norm_eps=cfg["norm_eps"], tie_embeddings=cfg["tie_word_embeddings"],
        ssm=Mamba2HeadsConfig(
            version=2, d_state=cfg["ssm_state_size"],
            d_conv=cfg["conv_kernel"], expand=cfg["expand"],
            headdim=cfg["mamba_head_dim"], n_groups=cfg["n_groups"],
            chunk=cfg["chunk_size"], mamba_heads=cfg["mamba_num_heads"]),
        moe=SigmoidMoEConfig(
            n_routed=cfg["n_routed_experts"],
            top_k=cfg["num_experts_per_tok"],
            n_shared=cfg["n_shared_experts"],
            d_ff_expert=cfg["moe_intermediate_size"], capacity_factor=None,
            router_norm_topk=cfg["norm_topk_prob"],
            routed_scaling=float(cfg["routed_scaling_factor"]),
            d_ff_shared=cfg["moe_shared_expert_intermediate_size"]),
        blocks=tuple(plan(cfg)))
