"""Learning-rate schedules: the port of `repro.optim.schedule`.

A schedule is a plain function of the step that returns a numpy float32
scalar: the f32 value the reference's schedule gives inside its jitted
train step, bit for bit.  XLA compiles the reference's arithmetic in a
particular order, which `cosine_schedule` repeats on the host: a
division by a constant is a product with the constant's f32 reciprocal,
the cosine term's multiply-add is fused (rounded once), and the cosine
is the C library's single-precision `cosf`, which XLA's CPU backend
calls.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math

import numpy as np

F32 = np.float32


@functools.cache
def _cosf():
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.cosf.restype = ctypes.c_float
    libm.cosf.argtypes = [ctypes.c_float]
    return libm.cosf


def cosine_schedule(peak: float, warmup: int, total: int, floor: float = 0.1):
    """Linear warmup -> cosine decay to `floor * peak`."""
    def lr(step) -> np.float32:
        step = F32(step)
        warm = F32(peak) * np.minimum(step * (F32(1) / F32(max(warmup, 1))), F32(1))
        frac = np.clip((step - F32(warmup)) * (F32(1) / F32(max(total - warmup, 1))),
                       F32(0), F32(1))
        cos = F32(_cosf()(float(F32(math.pi) * frac)))
        # floor*peak + (1-floor)*peak*0.5 * (1 + cos), one rounding: the two
        # f32 products are exact in float64
        decay = F32(float(F32(floor * peak))
                    + float(F32((1 - floor) * peak * 0.5)) * float(F32(1) + cos))
        return warm if step < warmup else decay
    return lr
