"""Multi-fidelity BO objective functions (a numpy copy of
`fidelityfusion_tpu/data/objectives.py`).

Re-design of `Data_simulation/Synthetic_MF_Function/
{Forrester,Non_linear_sin,Branin,Hartmann}.py`: objects with the
reference's protocol —

    get_data(x, s) -> y           (s: fidelity index, 1-based discrete
                                   or continuous z where noted)
    initiate_data(index, seed) -> (x_list, y_list)

plus a ``search_range`` box and a cost model.  Implemented in numpy
(objective evaluation is host-side data generation, not the compute path).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

from fidelityfusion_tpu_torch.data.cost import LinearCost, PowerCost


class Forrester:
    """Forrester 1-D with fidelity interpolation (`Forrester.py:17-72`):

        y_h(x) = (6x-2)^2 sin(12x-4),   y_l = 0.5 y_h + 10(x-0.5) + 5
        intermediate fidelity t: y_t = w_l(t) y_l + w_h(t) y_h,
        w_h(t) = t^2 + 0.1 sin(10 pi t)
    """

    def __init__(self, total_fidelity_num: int = 2):
        self.total_fidelity_num = total_fidelity_num
        self.x_dim = 1
        self.search_range = [[0, 1], [0, 1]]
        self.cost = PowerCost(base=10.0)

    @staticmethod
    def _w_h(t):
        return t**2 + 0.1 * np.sin(10 * np.pi * t)

    def get_data(self, x: np.ndarray, s: int) -> np.ndarray:
        """s is the 1-based fidelity index (`Forrester.py:50`)."""
        x = np.asarray(x, float).reshape(-1, 1)
        y_h = (6 * x - 2) ** 2 * np.sin(12 * x - 4)
        y_l = 0.5 * y_h + 10 * (x - 0.5) + 5
        ys = [y_l]
        ts = np.linspace(0, 1, self.total_fidelity_num)[1:-1]
        for t in ts:
            ys.append((1 - self._w_h(t)) * y_l + self._w_h(t) * y_h)
        ys.append(y_h)
        return ys[s - 1]

    def initiate_data(self, index: Dict[int, int], seed: int):
        """Seeded initial design (`Forrester.py:58-72`): fidelity-1 points
        sampled uniformly; each higher fidelity is a nested subset of the
        one below plus 2 fresh points (generalizes the reference's
        2-fidelity scheme to ``total_fidelity_num`` levels)."""
        rng = np.random.default_rng(seed)
        xs = [rng.random((index[1], 1))]
        for f in range(2, self.total_fidelity_num + 1):
            n_f = index.get(f, max(2, index[1] // (2 ** (f - 1))))
            xs.append(
                np.concatenate([xs[-1][: n_f - 2], rng.random((2, 1))], axis=0)
            )
        ys = [self.get_data(x, f + 1) for f, x in enumerate(xs)]
        return xs, ys

    Initiate_data = initiate_data  # reference-compatible alias


class NonLinearSin:
    """Nonlinear-sin two-fidelity objective (`Non_linear_sin.py`):
        y_l(x) = sin(8 pi x),   y_h(x) = (x - sqrt(2)) * y_l(x)^2
    """

    def __init__(self, total_fidelity_num: int = 2):
        self.total_fidelity_num = total_fidelity_num
        self.x_dim = 1
        self.search_range = [[0, 1], [0, 1]]
        self.cost = PowerCost(base=10.0)

    def get_data(self, x: np.ndarray, s: int) -> np.ndarray:
        x = np.asarray(x, float).reshape(-1, 1)
        y_l = np.sin(8 * np.pi * x)
        y_h = (x - np.sqrt(2.0)) * y_l**2
        return [y_l, y_h][min(s - 1, 1)]

    def initiate_data(self, index: Dict[int, int], seed: int):
        rng = np.random.default_rng(seed)
        x_low = rng.random((index[1], 1))
        x_high = np.concatenate([x_low[: index[2] - 2], rng.random((2, 1))], axis=0)
        return [x_low, x_high], [self.get_data(x_low, 1), self.get_data(x_high, 2)]

    Initiate_data = initiate_data


class Branin:
    """Continuous-fidelity Branin (maximization sign convention,
    `Branin.py:8-46`): fidelity z in [0,1] enters the `b` coefficient."""

    def __init__(self):
        self.x_dim = 2
        self.search_range = [[-5, 10], [0, 15], [0, 1]]
        self.cost = LinearCost(rate=10.0)
        self.b = 5.1 / (4 * math.pi**2)
        self.c = 5 / math.pi
        self.r = 6.0
        self.t = 1 / (8 * math.pi)

    def get_data(self, x: np.ndarray, s) -> np.ndarray:
        x = np.atleast_2d(np.asarray(x, float))
        s = np.broadcast_to(np.asarray(s, float).reshape(-1, 1), (len(x), 1))
        b_eff = self.b - 0.1 * (1 - s[:, 0])
        y = -(
            (x[:, 1] - b_eff * x[:, 0] ** 2 + self.c * x[:, 0] - self.r) ** 2
            + 10 * (1 - self.t) * np.cos(x[:, 0])
            + 10
        )
        return y.reshape(-1, 1)

    def initiate_data(self, num: int, seed: int):
        rng_list = [np.random.default_rng(seed + 217 + i) for i in range(self.x_dim)]
        cols = [
            r.random((num, 1)) * (hi - lo) + lo
            for r, (lo, hi) in zip(rng_list, self.search_range[: self.x_dim])
        ]
        x = np.concatenate(cols, axis=1)
        lo, hi = self.search_range[-1]
        s = np.random.default_rng(seed + 999).random((num, 1)) * (hi - lo) + lo
        y = self.get_data(x, s)
        return x, y, s

    Initiate_data = initiate_data


class Hartmann3:
    """Continuous-fidelity Hartmann-3D (`Hartmann.py` semantics): fidelity
    perturbs the alpha coefficients: alpha_eff = alpha - 0.1 (1 - z)."""

    A = np.array(
        [[3.0, 10, 30], [0.1, 10, 35], [3.0, 10, 30], [0.1, 10, 35]]
    )
    P = 1e-4 * np.array(
        [
            [3689, 1170, 2673],
            [4699, 4387, 7470],
            [1091, 8732, 5547],
            [381, 5743, 8828],
        ]
    )
    alpha = np.array([1.0, 1.2, 3.0, 3.2])

    def __init__(self):
        self.x_dim = 3
        self.search_range = [[0, 1]] * 3 + [[0, 1]]
        self.cost = LinearCost(rate=10.0)

    def get_data(self, x: np.ndarray, s) -> np.ndarray:
        x = np.atleast_2d(np.asarray(x, float))
        s = np.broadcast_to(np.asarray(s, float).reshape(-1, 1), (len(x), 1))
        alpha_eff = self.alpha[None, :] - 0.1 * (1 - s)  # (n, 4)
        inner = np.exp(
            -np.einsum("kd,nkd->nk", self.A, (x[:, None, :] - self.P[None, :, :]) ** 2)
        )
        y = np.sum(alpha_eff * inner, axis=1)
        return y.reshape(-1, 1)

    def initiate_data(self, num: int, seed: int):
        rng = np.random.default_rng(seed)
        x = rng.random((num, self.x_dim))
        s = rng.random((num, 1))
        return x, self.get_data(x, s), s

    Initiate_data = initiate_data
