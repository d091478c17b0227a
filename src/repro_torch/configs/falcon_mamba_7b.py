"""falcon-mamba-7b — attention-free Mamba1 [arXiv:2410.05355; unverified].

64L d_model=4096 d_state=16 vocab=65024; expand 2 (d_inner 8192).
"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=65024,
    ssm=SSMConfig(version=1, d_state=16, d_conv=4, expand=2, chunk=256),
    subquadratic=True,
    max_seq_len=1048576,
)
