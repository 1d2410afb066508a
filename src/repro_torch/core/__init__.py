# Counterpart of repro.core: datasets/comm are verbatim numpy copies so
# seeded data comes out bit-identical; geometry is torch.
from repro_torch.core import classifiers, comm, datasets, geometry  # noqa: F401
from repro_torch.core.protocols import kparty, one_way, two_way  # noqa: F401

__all__ = [
    "classifiers",
    "comm",
    "datasets",
    "geometry",
    "one_way",
    "two_way",
    "kparty",
]
