"""musicgen-large — decoder-only LM over EnCodec tokens [arXiv:2306.05284; hf].

48L d_model=2048 32H d_ff=8192 vocab=2048 x 4 codebooks (delay pattern handled
by the data pipeline; the LM embeds the 4 books additively and predicts 4
parallel heads).  EnCodec itself is a stub (frontends.py).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=2048,
    rope_theta=10000.0, n_codebooks=4,
    max_seq_len=32768,
)
