"""RWKV-6 (Finch) 7B [arXiv:2404.05892] — attention-free, data-dependent decay.

32L, d_model 4096 (64 WKV heads x 64), channel-mix d_ff 14336, vocab 65536.
"""
from repro_torch.models.config import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,      # wkv heads = d_model / rwkv.head_dim
    n_kv=64,
    d_ff=14336,
    vocab=65536,
    period=(("rwkv", "rwkv_cmix"),),
    rwkv=RWKVConfig(head_dim=64, decay_lora=64),
    rope="none",
    source="arXiv:2404.05892",
)
