# Counterpart of repro.models for the dense and encoder-decoder families:
# config is a verbatim copy (data only); layers, transformer and model are
# torch.  MoE, MLA, the SSM mixers and the VLM front end raise
# NotImplementedError naming the ROADMAP item that ports them.
from repro_torch.models import config, layers, model, transformer  # noqa: F401
