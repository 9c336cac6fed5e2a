"""The reference zoo's `multi_fidelity_p4_simp` (noise-free, A = 0): three
fidelities on [-6, 5]^2, returned low to high."""

from __future__ import annotations

import math

import numpy as np

LO, HI = -6.0, 5.0


def p4(x: np.ndarray):
    """[lo, mid, hi] at x (n, 2), each (n, 1) float64."""
    x = np.atleast_2d(np.asarray(x, np.float64))
    x1, x2 = x.T
    hi = (x1 ** 2 + x2 ** 2) / 25 - np.cos(x1) * np.cos(x2 / math.sqrt(2)) + 1
    mid = np.cos(x1) * np.cos(x2 / math.sqrt(2)) + 1
    lo = (x1 ** 2 + x2 ** 2) / 20 - np.cos(x1 / math.sqrt(2)) * np.cos(x2 / math.sqrt(3)) - 1
    return [v.reshape(-1, 1) for v in (lo, mid, hi)]


def uniform(rng: np.random.Generator, n: int) -> np.ndarray:
    """n points uniform on the p4 domain, float64."""
    return rng.random((n, 2)) * (HI - LO) + LO
