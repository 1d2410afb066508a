"""Learning-rate schedules (pure functions of the step counter).

Counterpart of ``repro.optim.schedule``, computed on the host in f32 one
operation at a time, as the JAX package computes them on an int32 step:
every sum, product and quotient rounds to f32, and the cosine is the C
library's ``cosf``, which XLA:CPU calls too, so the values equal JAX's.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math

import numpy as np

_F = np.float32


@functools.lru_cache(maxsize=None)
def _cosf():
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    fn = libm.cosf
    fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]
    return fn


def linear_warmup(step, warmup: int) -> np.float32:
    return min(_F(1.0), _F(int(step) + 1) / _F(max(warmup, 1)))


def cosine_schedule(step, warmup: int, total: int,
                    min_ratio: float = 0.1) -> np.float32:
    step = int(step)
    warm = linear_warmup(step, warmup)
    t = min(max(_F(step - warmup) / _F(max(total - warmup, 1)), _F(0.0)),
            _F(1.0))
    cos = _F(min_ratio) + _F((1 - min_ratio) * 0.5) * (
        _F(1.0) + _F(_cosf()(_F(math.pi) * t)))
    return warm * cos
