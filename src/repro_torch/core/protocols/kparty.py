"""k-party two-way protocols (paper §6.2, Thm 6.3, and the §7 k-party
MAXMARG); counterpart of ``repro.core.protocols.kparty``.

Both selectors run on the batched engine (:mod:`repro_torch.engine`): MEDIAN
as the certified-pivot epoch protocol in R^2, MAXMARG as the per-turn
max-margin refit in any dimension.  This is their single-instance entry
point, an engine sweep with B=1.
"""

from __future__ import annotations

from repro_torch.core.protocols.one_way import ProtocolResult


def iterative_support_kparty(
    shards,
    eps: float = 0.05,
    max_epochs: int = 48,
    n_angles: int = 1024,
    selector: str = "median",
    max_support: int = 4,
    device="cuda",
) -> ProtocolResult:
    from repro_torch import engine

    d = shards[0][0].shape[1]
    if selector == "maxmarg" or d != 2:
        # MAXMARG works in any dimension; MEDIAN is specified for R^2
        # (paper §8.2), so d != 2 routes to the MAXMARG selector too
        return engine.maxmarg.run_instances(
            [engine.ProtocolInstance(shards, eps, "maxmarg")],
            max_epochs=max_epochs, max_support=max_support,
            device=device)[0]
    return engine.run_instances(
        [engine.ProtocolInstance(shards, eps)],
        n_angles=n_angles, max_epochs=max_epochs, device=device)[0]
