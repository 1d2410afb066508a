"""Grok-1 314B [hf:xai-org/grok-1] — MoE, 8 experts top-2.

64L, d_model 6144, 48 heads (GQA kv=8), expert d_ff 32768, vocab 131072.
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv=8,
    d_ff=32768,
    vocab=131072,
    period=(("attn", "moe"),),
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=32768),
    rope="rope",
    sliding_window=16384,  # long_500k variant only
    source="hf:xai-org/grok-1",
)
