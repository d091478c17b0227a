"""Multi-head Latent Attention with a mixture of experts (DeepSeek-V2's
``config.json`` keys).  The published values the port's own registry
leaves at other defaults are set through its existing fields:
``norm_topk_prob`` through ``MoEConfig.router_norm_topk``,
``rms_norm_eps`` through ``norm_eps``.  The capacity factor and the
auxiliary weight are the file's ``assumed``."""
from __future__ import annotations

from types import SimpleNamespace
from typing import Mapping

from perfbench.weights import F32, ones, w


def sizes(cfg: Mapping) -> SimpleNamespace:
    return SimpleNamespace(
        family="mla_moe", d=cfg["hidden_size"],
        n_layers=cfg["num_hidden_layers"],
        n_lead=cfg["first_k_dense_replace"],
        heads=cfg["num_attention_heads"], r=cfg["kv_lora_rank"],
        nope=cfg["qk_nope_head_dim"], rope=cfg["qk_rope_head_dim"],
        vd=cfg["v_head_dim"], experts=cfg["n_routed_experts"],
        top_k=cfg["num_experts_per_tok"], shared=cfg["n_shared_experts"],
        ff=cfg["moe_intermediate_size"], ff_dense=cfg["intermediate_size"],
        vocab=cfg["vocab_size"], eps=cfg["rms_norm_eps"],
        theta=float(cfg["rope_theta"]), norm_topk=cfg["norm_topk_prob"],
        capacity_factor=cfg["assumed"]["capacity_factor"],
        aux_weight=cfg["assumed"]["aux_weight"])


def specs(s: SimpleNamespace) -> dict:
    def attn():
        return {"wq": w(s.d, s.heads * (s.nope + s.rope)),
                "w_dkv": w(s.d, s.r), "w_krope": w(s.d, s.rope),
                "kv_norm": {"scale": ones(s.r)},
                "w_uk": w(s.r, s.heads * s.nope),
                "w_uv": w(s.r, s.heads * s.vd),
                "wo": w(s.heads * s.vd, s.d)}

    def mlp(ff):
        return {"w_gate": w(s.d, ff), "w_up": w(s.d, ff),
                "w_down": w(ff, s.d)}

    def block(moe: bool):
        b = {"ln1": {"scale": ones(s.d)}, "ln2": {"scale": ones(s.d)},
             "attn": attn()}
        if moe:
            E = s.experts
            b["moe"] = {"router": w(s.d, E, dtype=F32),
                        "w_gate": w(E, s.d, s.ff), "w_up": w(E, s.d, s.ff),
                        "w_down": w(E, s.ff, s.d)}
            if s.shared:
                b["moe"]["shared"] = mlp(s.shared * s.ff)
        else:
            b["mlp"] = mlp(s.ff_dense)
        return b
    return {"embed": w(s.vocab, s.d, std=1.0),
            "final_norm": {"scale": ones(s.d)}, "lm_head": w(s.d, s.vocab),
            "lead": [block(False) for _ in range(s.n_lead)],
            "blocks": [block(True) for _ in range(s.n_layers - s.n_lead)]}


def model_config(cfg: Mapping):
    from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig
    if cfg["q_lora_rank"] is not None:
        raise ValueError("the port's MLA has no query compression")
    return ModelConfig(
        name=cfg["name"], family="moe", n_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        rope_theta=float(cfg["rope_theta"]), norm_eps=cfg["rms_norm_eps"],
        tie_embeddings=cfg["tie_word_embeddings"],
        mla=MLAConfig(kv_lora_rank=cfg["kv_lora_rank"],
                      qk_nope_head_dim=cfg["qk_nope_head_dim"],
                      qk_rope_head_dim=cfg["qk_rope_head_dim"],
                      v_head_dim=cfg["v_head_dim"]),
        moe=MoEConfig(n_routed=cfg["n_routed_experts"],
                      top_k=cfg["num_experts_per_tok"],
                      n_shared=cfg["n_shared_experts"],
                      d_ff_expert=cfg["moe_intermediate_size"],
                      capacity_factor=cfg["assumed"]["capacity_factor"],
                      first_dense_layers=cfg["first_k_dense_replace"],
                      d_ff_dense=cfg["intermediate_size"],
                      router_norm_topk=cfg["norm_topk_prob"]))
