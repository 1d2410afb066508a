"""Jamba-1.5-Large 398B [arXiv:2403.19887] — Mamba + attention 1:7, MoE 16e top-2.

72L = 9 periods of 8 (attention at in-period index 4, Mamba elsewhere; MoE on
odd in-period indices, dense MLP on even), d_model 8192, 64 heads (GQA kv=8),
d_ff 24576, vocab 65536.
"""
from repro_torch.models.config import ModelConfig, MoEConfig, SSMConfig

_PERIOD = tuple(
    ("attn" if i == 4 else "mamba", "moe" if i % 2 == 1 else "mlp") for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv=8,
    d_ff=24576,
    vocab=65536,
    period=_PERIOD,
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=24576),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    rope="rope",
    source="arXiv:2403.19887",
)
