from repro_torch.core.protocols import (  # noqa: F401
    baselines,
    kparty,
    one_way,
    two_way,
)
