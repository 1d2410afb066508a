"""Qwen2-VL-2B [arXiv:2409.12191] — VLM backbone; ViT frontend stubbed.

28L, d_model 1536, 12 heads (GQA kv=2), d_ff 8960, vocab 151936, M-RoPE with
(16, 24, 24) sections over the 128-dim head.  ``input_specs`` provides
precomputed patch embeddings + 3-D (temporal, h, w) position ids.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv=2,
    d_ff=8960,
    vocab=151936,
    qkv_bias=True,
    period=(("attn", "mlp"),),
    rope="mrope",
    mrope_sections=(16, 24, 24),
    sliding_window=16384,  # long_500k variant only
    source="arXiv:2409.12191",
)
