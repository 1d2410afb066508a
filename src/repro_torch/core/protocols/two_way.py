"""Two-way two-party ITERATIVESUPPORTS (paper §4–5); counterpart of
``repro.core.protocols.two_way``.

Both selectors are the k=2 instances of the k-party epoch protocols, run on
the batched engine with B=1: MAXMARG (§4.4, any dimension) and MEDIAN (the
certified-pivot protocol in R^2).
"""

from __future__ import annotations

from repro_torch.core.protocols.one_way import ProtocolResult


def iterative_support_maxmarg(
    shards,
    eps: float = 0.05,
    max_rounds: int = 64,
    max_support: int = 4,
    device="cuda",
) -> ProtocolResult:
    """Paper §4.4 MAXMARG for two parties: each turn one party refits
    max-margin on everything it knows and ships its active-margin support
    points; the peer answers with an all-clear bit or its most-violated
    points.  ``max_rounds`` counts turns and maps to ``max_rounds // 2``
    two-turn epochs (at least 1); the result's ``rounds`` counts epochs,
    ``comm["rounds"]`` turns."""
    from repro_torch.core.protocols.kparty import iterative_support_kparty
    return iterative_support_kparty(shards[:2], eps=eps,
                                    max_epochs=max(1, max_rounds // 2),
                                    selector="maxmarg",
                                    max_support=max_support, device=device)


def iterative_support_median(
    shards,
    eps: float = 0.05,
    max_rounds: int = 64,
    n_angles: int = 1024,
    device="cuda",
) -> ProtocolResult:
    """Paper §5 protocol with the certified-pivot reply (DESIGN.md): the
    receiver replies with its extreme band points — the paper's §5.2
    pivoting rule — which never discards a consistent direction."""
    from repro_torch.core.protocols.kparty import iterative_support_kparty
    return iterative_support_kparty(shards[:2], eps=eps,
                                    max_epochs=max_rounds // 2,
                                    n_angles=n_angles, selector="median",
                                    device=device)
