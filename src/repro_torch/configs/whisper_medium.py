"""Whisper-medium [arXiv:2212.04356] — encoder-decoder; conv/mel frontend stubbed.

24 encoder + 24 decoder layers, d_model 1024, 16 heads (MHA), GELU d_ff 4096,
vocab 51865.  ``input_specs`` provides precomputed frame embeddings (the
carve-out allowed for audio frontends).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv=16,
    d_ff=4096,
    vocab=51865,
    period=(("attn", "gelu_mlp"),),
    enc_dec=True,
    n_enc_layers=24,
    rope="none",  # whisper uses learned/sinusoidal absolute positions
    act="gelu",
    source="arXiv:2212.04356",
)
