"""Discrete multi-fidelity acquisitions and fidelity selection.

Port of `fidelityfusion_tpu/bo/mf_acq.py`: acquisitions over per-fidelity
posteriors, with the reference's conventions kept:

  * ``beta = 0.2 * x_dimension``;
  * UCB_MF uses the *variance* (not std) in the bonus;
  * EI_MF / KG_MF as their single-fidelity counterparts at fidelity s;
  * PI_MF returns the log-density score of the improvement z-value.

`DiscreteMFAcquisition.acq_selection_fidelity` is the MF-GP-UCB ladder:
query the LOWEST fidelity whose posterior variance is still informative
(beta * var > gamma_s escalates past it).  `optimize_acq_mf` runs the
multi-start Adam of `bo/optimize.py` per fidelity and keeps the best.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from fidelityfusion_tpu_torch.bo import acq as sf_acq
from fidelityfusion_tpu_torch.bo.optimize import optimize_acqf


def _log_density_score(mean, var, f_best, theta: float = 0.01):
    """The reference's PI_MF: the log normal density of the improvement
    z-value."""
    std = torch.clamp(torch.sqrt(torch.clamp(var, min=1e-18)), min=1e-9)
    z = (mean - f_best - theta) / std
    return -0.5 * z * z - 0.5 * math.log(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class MFAcqScore:
    """Acquisition score over an exported posterior: ``posterior(state, x)
    -> (mean, var)`` (e.g. `models/ar.py:ARPosterior`), called as
    ``score(x, state, f_best)``, the call form `optimize_acqf`'s
    ``acq_args`` gives it.

    UCB is scored in the surrogate's normalized-y space (``y_shift``,
    ``y_scale``: the export's y statistics), the space of the loop's
    fidelity gate; PI is the log-density score; KG uses the fixed draw
    ``kg_eps`` ``(num_fantasies, n)``, or N(0, 1) from a generator seeded 0
    at each call (the JAX score's fixed key).
    """

    posterior: Any
    method: str = "UCB"
    beta: float = 0.2
    num_fantasies: int = 10
    y_shift: float = 0.0
    y_scale: float = 1.0
    kg_eps: Optional[torch.Tensor] = None

    def __call__(self, x, state, f_best):
        mean, var = self.posterior(state, x)
        mean = mean.reshape(-1)
        var = var.reshape(-1)
        if self.method == "UCB":
            mean_n = (mean - self.y_shift) / self.y_scale
            var_n = var / (self.y_scale * self.y_scale)
            return mean_n + self.beta * var_n
        if self.method == "EI":
            return sf_acq.ei(mean, var, f_best)
        if self.method == "PI":
            return _log_density_score(mean, var, f_best)
        if self.method == "KG":
            return sf_acq.kg(mean, var, f_best, eps=self.kg_eps,
                             num_fantasies=self.num_fantasies)
        raise ValueError(f"unknown method {self.method!r}")


class DiscreteMFAcquisition:
    """Per-fidelity posterior closures and their acquisition scores:
    ``mean_fn(x, s)`` / ``var_fn(x, s)`` take x ``(n, d)`` and a Python int
    fidelity s and return ``(n,)`` tensors."""

    def __init__(self, mean_fn: Callable, var_fn: Callable, fidelity_num: int,
                 x_dimension: int, f_best=None):
        self.mean_fn = mean_fn
        self.var_fn = var_fn
        self.fidelity_num = fidelity_num
        self.x_dimension = x_dimension
        self.f_best = f_best
        self.beta = 0.2 * x_dimension

    def UCB_MF(self, x, s: int):
        return self.mean_fn(x, s) + self.beta * self.var_fn(x, s)

    def EI_MF(self, x, s: int, xi: float = 0.01):
        return sf_acq.ei(self.mean_fn(x, s), self.var_fn(x, s), self.f_best, xi)

    def PI_MF(self, x, s: int, theta: float = 0.01):
        return _log_density_score(self.mean_fn(x, s), self.var_fn(x, s), self.f_best, theta)

    def KG_MF(self, x, s: int, eps: Optional[torch.Tensor] = None, num_fantasies: int = 10):
        """KG at fidelity s with the draws ``eps`` (a generator seeded 0
        when None, the JAX method's default key)."""
        return sf_acq.kg(self.mean_fn(x, s), self.var_fn(x, s), self.f_best, eps=eps,
                         num_fantasies=num_fantasies)

    def acq_selection_fidelity(self, gamma: Sequence[float], new_x) -> int:
        """MF-GP-UCB fidelity ladder: the LOWEST fidelity whose posterior is
        still uncertain (beta * var > gamma_s); the top one when every
        fidelity is confident."""
        for s in range(self.fidelity_num):
            v = float(torch.max(self.var_fn(new_x, s)))
            if self.beta * v > gamma[s]:
                return s
        return self.fidelity_num - 1


def optimize_acq_mf(acq_score: Callable[[torch.Tensor, int], torch.Tensor], fidelity_num: int,
                    bounds, generator: Optional[torch.Generator] = None,
                    n_iterations: int = 30, learning_rate: float = 0.1, raw_samples: int = 16,
                    starts: Optional[Sequence[torch.Tensor]] = None,
                    device="cuda") -> Tuple[torch.Tensor, int, torch.Tensor]:
    """Optimize x per fidelity (multi-start Adam from ``starts[s]``, or
    from uniform starts drawn in turn from ``generator``, seeded 0 if None)
    and return the (x, fidelity) with the best acquisition score:
    ``(best_x (d,), best_fidelity, best_score)``."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    best_x: List[torch.Tensor] = []
    best_v: List[torch.Tensor] = []
    for s in range(fidelity_num):
        x_s, v_s = optimize_acqf(
            lambda x, s=s: acq_score(x, s), bounds,
            generator,
            raw_samples=raw_samples, steps=n_iterations, lr=learning_rate,
            x0=starts[s] if starts is not None else None, device=device)
        best_x.append(x_s)
        best_v.append(v_s)
    scores = torch.stack(best_v)
    s_star = int(torch.argmax(scores))
    return best_x[s_star], s_star, scores[s_star]
