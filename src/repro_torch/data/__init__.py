from repro_torch.data.pipeline import DataConfig, dec_len, synthetic_stream  # noqa: F401
