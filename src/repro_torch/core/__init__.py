# Counterpart of repro.core: datasets/comm/sampling are verbatim numpy
# copies so seeded data comes out bit-identical; geometry and prng (JAX's
# Threefry draws) are torch.
from repro_torch.core import classifiers, comm, datasets  # noqa: F401
from repro_torch.core import geometry, prng, sampling  # noqa: F401
from repro_torch.core.protocols import (  # noqa: F401
    baselines,
    kparty,
    one_way,
    two_way,
)

__all__ = [
    "baselines",
    "classifiers",
    "comm",
    "datasets",
    "geometry",
    "one_way",
    "prng",
    "sampling",
    "two_way",
    "kparty",
]
