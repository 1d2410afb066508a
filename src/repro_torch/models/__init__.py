# Counterpart of repro.models for every family (dense, MoE with MLA, SSM,
# hybrid, audio, VLM): config is a verbatim copy (data only); layers, moe,
# ssm, transformer and model are torch.
from repro_torch.models import (  # noqa: F401
    config,
    layers,
    model,
    moe,
    ssm,
    transformer,
)
