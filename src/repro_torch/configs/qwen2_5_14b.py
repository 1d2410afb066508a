"""Qwen2.5-14B [hf:Qwen/Qwen2.5-0.5B family card] — dense, GQA kv=8, QKV bias.

48L, d_model 5120, 40 heads, d_ff 13824, vocab 152064.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv=8,
    d_ff=13824,
    vocab=152064,
    qkv_bias=True,
    period=(("attn", "mlp"),),
    rope="rope",
    sliding_window=16384,  # long_500k variant only
    source="hf:Qwen/Qwen2.5-0.5B",
)
