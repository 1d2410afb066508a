"""k-party two-way protocol for halfspaces in R^2 (paper §6.2, Thm 6.3);
counterpart of ``repro.core.protocols.kparty``.

The certified-pivot epoch protocol runs on the batched engine
(:mod:`repro_torch.engine`); this is its single-instance entry point, an
engine sweep with B=1.
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
        # the JAX package routes MAXMARG, and MEDIAN outside R^2, to the
        # MAXMARG selector
        raise NotImplementedError(
            "the MAXMARG selector is not ported yet: ROADMAP Queue 1 item 6")
    return engine.run_instances(
        [engine.ProtocolInstance(shards, eps)],
        n_angles=n_angles, max_epochs=max_epochs, device=device)[0]
