"""zamba2-1.2b — Mamba2 + weight-shared attention blocks [arXiv:2411.15242; hf].

38 mamba2 layers (d_model=2048, ssm_state=64, headdim=64) with one shared
attention+MLP block (32H, d_ff=8192) invoked every 6 layers; vocab 32000.
The HF model concatenates raw embeddings into the shared block (2x width) and
adds per-call-site LoRA on it; we keep the shared block at d_model and share
it exactly (DESIGN.md §5).
"""
from repro_torch.models.config import ModelConfig, SSMConfig, HybridConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32000,
    ssm=SSMConfig(version=2, d_state=64, d_conv=4, expand=2, headdim=64,
                  n_groups=1, chunk=256),
    hybrid=HybridConfig(shared_attn_every=6),
    subquadratic=True,
    max_seq_len=1048576,
)
