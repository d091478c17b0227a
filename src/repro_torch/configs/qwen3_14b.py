"""qwen3-14b — dense GQA with qk-norm [hf:Qwen/Qwen3-8B family; hf].

40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8,
    head_dim=128,
    d_ff=17408, vocab_size=151936,
    rope_theta=1000000.0, qk_norm=True,
    max_seq_len=40960,
)
