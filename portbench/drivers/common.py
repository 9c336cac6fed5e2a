"""Pieces the drivers share: seeded generators, the stage clock at the
trainers' `record_stage` hook, and the sample of units a check compares."""

from __future__ import annotations

import time
from typing import List

import numpy as np


def _entropy(seed: int, salt) -> list:
    """Whole numbers of either sign as the non-negative words a
    `SeedSequence` takes: each as its magnitude and its sign."""
    return [w for v in (seed, *salt) for w in (abs(int(v)), int(v < 0))]


def rng(seed: int, *salt: int) -> np.random.Generator:
    """A numpy generator of its own for ``(seed, *salt)``; any whole seed."""
    return np.random.default_rng(np.random.SeedSequence(_entropy(seed, salt)))


class StageClock:
    """The trainers' ``debugger``: at each stage's end it waits for the
    device and notes the stage's wall seconds, as a harness span."""

    def __init__(self, run, t0: float):
        self.run, self.t = run, t0
        self.stage_s: List[float] = []

    def record_stage(self, stage: int, losses) -> None:
        self.run.sync()
        t = time.time()
        self.stage_s.append(t - self.t)
        self.run.spans.append((f"stage{stage}", int(self.t * 1e9), int(t * 1e9)))
        self.t = t


def sample(seed: int, n_units: int, k: int, salt: int = 7) -> List[int]:
    """Up to ``k`` distinct unit indices drawn from the seed, the last
    unit always among them."""
    if n_units == 0:
        return []
    r = rng(seed, salt)
    others = r.permutation(n_units - 1)[: max(0, k - 1)].tolist()
    return sorted(set(others + [n_units - 1]))


def rel_gap(a: np.ndarray, b: np.ndarray, scale: float) -> float:
    """max |a - b| / scale, NaN-aware (a NaN reads as infinite)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = np.abs(a - b)
    if not np.all(np.isfinite(d)):
        return float("inf")
    return float(d.max() / scale) if d.size else 0.0
