"""Two-way two-party ITERATIVESUPPORTS (paper §4–5); counterpart of
``repro.core.protocols.two_way``.

Only the MEDIAN selector is ported so far: the certified-pivot protocol as
the k=2 instance of the k-party epoch protocol, run on the batched engine
with B=1.
"""

from __future__ import annotations

from repro_torch.core.protocols.one_way import ProtocolResult


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
