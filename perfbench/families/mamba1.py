"""Mamba1 (FalconMamba's ``config.json`` keys).  The port's Mamba1 takes
its dt rank as d // 16, its B/C/dt have no RMSNorm (a departure the
configuration file records)."""
from __future__ import annotations

from types import SimpleNamespace
from typing import Mapping

from perfbench.weights import F32, ones, w, zeros


def sizes(cfg: Mapping) -> SimpleNamespace:
    d = cfg["hidden_size"]
    return SimpleNamespace(
        family="mamba1", d=d, n_layers=cfg["num_hidden_layers"],
        d_in=cfg["expand"] * d, n=cfg["state_size"],
        d_conv=cfg["conv_kernel"], r=cfg["time_step_rank"],
        vocab=cfg["vocab_size"], eps=cfg["layer_norm_epsilon"],
        dt_min=cfg["time_step_min"], dt_max=cfg["time_step_max"])


def specs(s: SimpleNamespace) -> dict:
    def layer():
        return {"ln": {"scale": ones(s.d)}, "ssm": {
            "in_x": w(s.d, s.d_in), "in_z": w(s.d, s.d_in),
            "conv_w": w(s.d_conv, s.d_in, std=s.d_conv ** -0.5),
            "conv_b": zeros(s.d_in),
            "x_proj": w(s.d_in, s.r + 2 * s.n), "dt_proj": w(s.r, s.d_in),
            "dt_bias": ((s.d_in,), F32, ("dt_bias", s.dt_min, s.dt_max)),
            "A_log": ((s.d_in, s.n), F32, ("a_log", s.n)),
            "D": ones(s.d_in, F32), "out_proj": w(s.d_in, s.d)}}
    return {"embed": w(s.vocab, s.d, std=1.0),
            "final_norm": {"scale": ones(s.d)}, "lm_head": w(s.d, s.vocab),
            "blocks": [layer() for _ in range(s.n_layers)]}


def model_config(cfg: Mapping):
    from repro_torch.models.config import ModelConfig, SSMConfig
    d = cfg["hidden_size"]
    if cfg["time_step_rank"] != max(1, d // 16):
        raise ValueError("the port's Mamba1 takes dt rank d // 16, "
                         f"not {cfg['time_step_rank']}")
    return ModelConfig(
        name=cfg["name"], family="ssm", n_layers=cfg["num_hidden_layers"],
        d_model=d, n_heads=0, n_kv_heads=0, d_ff=0,
        vocab_size=cfg["vocab_size"],
        ssm=SSMConfig(version=1, d_state=cfg["state_size"],
                      d_conv=cfg["conv_kernel"], expand=cfg["expand"]),
        tie_embeddings=cfg["tie_word_embeddings"],
        norm_eps=cfg["layer_norm_epsilon"], subquadratic=True)
