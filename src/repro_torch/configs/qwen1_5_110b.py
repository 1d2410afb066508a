"""Qwen1.5-110B [hf:Qwen/Qwen1.5-0.5B family card] — dense, QKV bias.

80L, d_model 8192, 64 heads (GQA kv=8), d_ff 49152, vocab 152064.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv=8,
    d_ff=49152,
    vocab=152064,
    qkv_bias=True,
    period=(("attn", "mlp"),),
    rope="rope",
    sliding_window=16384,  # long_500k variant only
    source="hf:Qwen/Qwen1.5-0.5B",
)
