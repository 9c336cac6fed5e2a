"""Single-fidelity acquisition functions over posterior mean and variance.

Port of `fidelityfusion_tpu/bo/acq.py`: each acquisition is a function of
mean and variance tensors, differentiable end to end, and written to be
MAXIMIZED.  The normal CDF is `torch.special.ndtr`; the density is
written out.  Every floor of the JAX functions is kept.

`kg` draws its fantasies from ``eps`` when given (the JAX package's draws,
carried across as an array) and otherwise from ``generator``, on the CPU,
then moves them to the mean's device: one seed gives the same fantasies on
the CPU and on the card.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def norm_pdf(z: torch.Tensor) -> torch.Tensor:
    """The standard normal density."""
    return torch.exp(-0.5 * z * z) * _INV_SQRT_2PI


def _std(var, floor: float) -> torch.Tensor:
    return torch.clamp(torch.sqrt(torch.clamp(var, min=1e-18)), min=floor)


def ucb(mean: torch.Tensor, var: torch.Tensor, kappa: float = 2.0) -> torch.Tensor:
    """Upper confidence bound: mean + kappa * std."""
    return mean + kappa * torch.sqrt(torch.clamp(var, min=0.0))


def ei(mean: torch.Tensor, var: torch.Tensor, f_best, xi: float = 0.01) -> torch.Tensor:
    """Expected improvement over ``f_best`` (max convention)."""
    std = _std(var, 1e-9)
    imp = mean - f_best - xi
    z = imp / std
    return imp * torch.special.ndtr(z) + std * norm_pdf(z)


def pi(mean: torch.Tensor, var: torch.Tensor, f_best, theta: float = 0.01) -> torch.Tensor:
    """Probability of improvement."""
    return torch.special.ndtr((mean - f_best - theta) / _std(var, 1e-9))


def fantasy_normal(shape, generator: Optional[torch.Generator], like: torch.Tensor):
    """N(0, 1) draws of ``shape`` from ``generator`` (a fresh one seeded 0
    if None) on the CPU, moved to ``like``'s device and dtype."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return torch.randn(tuple(shape), generator=generator).to(like.device, like.dtype)


def kg(mean: torch.Tensor, var: torch.Tensor, f_best, eps: Optional[torch.Tensor] = None,
       num_fantasies: int = 10, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Fantasy-sample knowledge gradient: ``num_fantasies`` posterior
    samples, the improvement of the per-point best over ``f_best``,
    averaged.  ``eps`` ``(num_fantasies, *mean.shape)`` are the standard
    normal draws; without it they come from ``generator``."""
    std = _std(var, 1e-6)
    if eps is None:
        eps = fantasy_normal((num_fantasies,) + tuple(mean.shape), generator, mean)
    fantasies = mean + std * eps.to(mean.device, mean.dtype)
    best = fantasies.max(dim=0).values
    return (best - f_best).mean(-1) if best.ndim > 1 else best - f_best


def pf(mean: torch.Tensor, var: torch.Tensor, thresholds: Sequence[float]) -> torch.Tensor:
    """Probability of feasibility under per-output constraints: product
    over columns of P(y_i <= threshold_i)."""
    th = torch.as_tensor(thresholds, dtype=mean.dtype, device=mean.device)
    return torch.special.ndtr((th[None, :] - mean) / _std(var, 1e-9)).prod(-1)


def mean_sigma_ratio(mean: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
    """mean / std, one of the MACE ensemble objectives."""
    return mean / _std(var, 1e-9)
