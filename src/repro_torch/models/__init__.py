# Counterpart of repro.models for the dense, encoder-decoder, SSM and
# hybrid families: config is a verbatim copy (data only); layers, ssm,
# transformer and model are torch.  MoE, MLA and the VLM front end raise
# NotImplementedError naming the ROADMAP item that ports them.
from repro_torch.models import (  # noqa: F401
    config,
    layers,
    model,
    ssm,
    transformer,
)
