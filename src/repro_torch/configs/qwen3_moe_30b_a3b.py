"""qwen3-moe-30b-a3b — 128-expert top-8 MoE [hf:Qwen/Qwen3-30B-A3B; hf].

48L d_model=2048 32H (GQA kv=4) d_ff(expert)=768 vocab=151936; qk-norm.
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
    head_dim=128,
    d_ff=768, vocab_size=151936,
    rope_theta=1000000.0, qk_norm=True,
    moe=MoEConfig(n_routed=128, top_k=8, n_shared=0, d_ff_expert=768),
    max_seq_len=40960,
)
