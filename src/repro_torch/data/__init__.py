from repro_torch.data.pipeline import (  # noqa: F401
    DataConfig,
    dec_len,
    make_batch_specs,
    synthetic_stream,
)
