"""SmolLM-135M [hf:HuggingFaceTB/SmolLM-135M] — llama-arch small.

30L, d_model 576, 9 heads (GQA kv=3), d_ff 1536, vocab 49152.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv=3,
    d_ff=1536,
    vocab=49152,
    period=(("attn", "mlp"),),
    rope="rope",
    rope_theta=1e4,
    tie_embeddings=True,
    sliding_window=16384,  # long_500k variant only
    source="hf:HuggingFaceTB/SmolLM-135M",
)
