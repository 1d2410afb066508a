"""DeepSeek-V2 236B [arXiv:2405.04434] — MoE with Multi-head Latent Attention.

60L, d_model 5120, 128 heads (MLA: qk = 128 nope + 64 rope, v 128,
kv compression rank 512), 160 routed experts top-6 + 2 shared, expert
d_ff 1536, vocab 102400.
"""
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv=128,
    d_ff=1536,
    vocab=102400,
    head_dim=128,
    period=(("mla", "moe"),),
    moe=MoEConfig(n_experts=160, top_k=6, d_expert=1536, n_shared=2),
    mla=MLAConfig(kv_lora=512, q_lora=1536, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
    rope="rope",
    rope_theta=1e4,
    sliding_window=16384,  # long_500k variant only
    source="arXiv:2405.04434",
)
