"""Classifier records (counterpart of ``repro.core.classifiers``).

Only :class:`LinearSeparator` is ported so far — the MEDIAN engine's result
type.  The batched max-margin solver comes with the MAXMARG slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class LinearSeparator:
    w: np.ndarray  # (d,)
    b: float
    margin: float = 0.0  # geometric margin on the fit set

    def predict(self, X: np.ndarray) -> np.ndarray:
        return np.where(np.atleast_2d(X) @ self.w + self.b > 0, 1, -1)

    def decision(self, X: np.ndarray) -> np.ndarray:
        return np.atleast_2d(X) @ self.w + self.b

    def error(self, X: np.ndarray, y: np.ndarray) -> float:
        return float(np.mean(self.predict(X) != y)) if len(y) else 0.0
