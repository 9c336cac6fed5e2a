"""Fidelity cost models (a numpy copy of `fidelityfusion_tpu/data/cost.py`).

Re-design of `Data_simulation/Cost_Function/{cost5,cost10,
cost_pow_10}.py`: query cost as a function of fidelity (discrete index or
continuous z), plus dataset-cost accounting used by the MFBO loops
(`cost10.py:22-36`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class LinearCost:
    """c(z) = floor(z * rate) for scalars (cost5: rate=5; cost10: rate=10 —
    `cost10.py:8-20`; arrays use floor((z+1)*rate))."""

    rate: float = 10.0

    def compute_cost(self, z):
        if isinstance(z, np.ndarray):
            return np.floor((z + 1) * self.rate)
        return int(z * self.rate)

    def compute_model_cost(self, dataset: Sequence[np.ndarray]) -> float:
        """Sum over fidelities of per-sample cost (`cost10.py:22-26`)."""
        return float(
            sum(self.compute_cost(i + 1) * len(d) for i, d in enumerate(dataset))
        )

    def compute_index(self, index: Dict) -> float:
        """Cost of an init-data index {fidelity: count} (`cost10.py:28-32`)."""
        return float(
            sum(self.compute_cost(int(k)) * int(v) for k, v in index.items())
        )


@dataclasses.dataclass(frozen=True)
class PowerCost:
    """c(s) = base^s — exponentially growing fidelity cost
    (`cost_pow_10.py` semantics)."""

    base: float = 10.0

    def compute_cost(self, z):
        return np.power(self.base, np.asarray(z, float))

    def compute_model_cost(self, dataset: Sequence[np.ndarray]) -> float:
        return float(
            sum(self.compute_cost(i + 1) * len(d) for i, d in enumerate(dataset))
        )

    def compute_index(self, index: Dict) -> float:
        return float(
            sum(self.compute_cost(int(k)) * int(v) for k, v in index.items())
        )


@dataclasses.dataclass(frozen=True)
class ContinuousCost:
    """Continuous-fidelity cost c(z) = (z+1)*rate for arrays / z*rate for
    scalars, with the log-transform fidelity mapping (`cost10.py:42-66`)."""

    rate: float = 2.0
    s_min: float = 0.1
    s_max: float = 1.0

    def transform(self, s):
        return (np.log2(s) - np.log2(self.s_min)) / (
            np.log2(self.s_max) - np.log2(self.s_min)
        )

    def compute_cost(self, z):
        if isinstance(z, np.ndarray):
            return (z + 1) * self.rate
        return z * self.rate

    def compute_model_cost(self, dataset, s_index) -> float:
        return float(sum(np.sum(self.compute_cost(s)) for s in s_index))
