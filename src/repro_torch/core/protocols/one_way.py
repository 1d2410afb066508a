"""Protocol result record (counterpart of ``repro.core.protocols.one_way``).

Only :class:`ProtocolResult` is ported so far; the one-way protocols come
with the one-way sampling slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np


@dataclasses.dataclass
class ProtocolResult:
    classifier: Any
    comm: dict
    rounds: int
    converged: bool
    extra: Optional[dict] = None

    def error_on(self, X: np.ndarray, y: np.ndarray) -> float:
        return self.classifier.error(X, y)

    def accuracy_on(self, X: np.ndarray, y: np.ndarray) -> float:
        return 1.0 - self.error_on(X, y)
