"""DeepSeek-LLM 7B [arXiv:2401.02954] — llama-arch dense, MHA.

30L, d_model 4096, 32 heads (kv=32 = MHA), d_ff 11008, vocab 102400.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv=32,
    d_ff=11008,
    vocab=102400,
    period=(("attn", "mlp"),),
    rope="rope",
    rope_theta=1e4,
    sliding_window=16384,  # long_500k variant only
    source="arXiv:2401.02954",
)
