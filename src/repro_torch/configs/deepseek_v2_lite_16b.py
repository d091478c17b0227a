"""deepseek-v2-lite-16b — MLA + MoE [arXiv:2405.04434; hf].

27L d_model=2048 16H d_ff(expert)=1408 vocab=102400; MLA kv_lora_rank=512,
qk_rope 64 / qk_nope 128 / v 128; MoE 64 routed top-6 + 2 shared; first layer
dense (d_ff 10944).  (The assignment line also mentions "160 routed" — that is
full V2; the Lite config per the paper is 64 routed.  See DESIGN.md §5.)
"""
from repro_torch.models.config import ModelConfig, MLAConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=10944, vocab_size=102400,
    rope_theta=10000.0,
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_routed=64, top_k=6, n_shared=2, d_ff_expert=1408,
                  first_dense_layers=1, d_ff_dense=10944),
    max_seq_len=32768,
)
