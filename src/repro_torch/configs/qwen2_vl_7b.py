"""qwen2-vl-7b — VLM backbone with M-RoPE [arXiv:2409.12191; hf].

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.  Vision tower is a
stub: input_specs provides merged patch+text embeddings and 3-stream M-RoPE
position ids (see models/frontends.py).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab_size=152064,
    rope_theta=1000000.0, mrope=True, mrope_sections=(16, 24, 24),
    embed_inputs=False,
    max_seq_len=32768,
)
