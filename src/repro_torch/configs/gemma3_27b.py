"""gemma3-27b — dense, 5:1 local:global attention [hf:google/gemma-3; unverified].

62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144; sliding window 1024
on local layers; qk-norm; 128k context.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b", family="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16,
    head_dim=128,
    d_ff=21504, vocab_size=262144,
    rope_theta=1000000.0, qk_norm=True,
    sliding_window=1024, local_global_ratio=5,
    tie_embeddings=True,
    max_seq_len=131072,
)
