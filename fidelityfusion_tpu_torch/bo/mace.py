"""MACE: multi-objective acquisition-ensemble candidate selection.

Port of `fidelityfusion_tpu/bo/mace.py`: six acquisition objectives (-UCB,
-PI, -EI, -PF, mean, mean/sigma) define a multi-objective problem; the
Pareto front of a sampled candidate set is found by vectorized
non-domination filtering, and one front member is picked at random.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from fidelityfusion_tpu_torch.bo import acq as sf_acq
from fidelityfusion_tpu_torch.bo.optimize import box, uniform
from fidelityfusion_tpu_torch.utils.device import resolve_device


def pareto_mask(objectives: torch.Tensor) -> torch.Tensor:
    """Boolean mask of the non-dominated rows of ``(n, k)`` objectives
    (minimization)."""
    o = objectives[:, None, :]
    p = objectives[None, :, :]
    dominated_by = (p <= o).all(-1) & (p < o).any(-1)  # (n, n)
    return ~dominated_by.any(1)


def mace_objectives(mean: torch.Tensor, var: torch.Tensor, f_best: float,
                    thresholds: Optional[Sequence[float]] = None,
                    kappa: float = 2.0) -> torch.Tensor:
    """The six MACE objectives, all to MINIMIZE, ``(n, 6)``."""
    mean = mean.reshape(-1)
    var = var.reshape(-1)
    feasible = (sf_acq.pf(mean[:, None], var[:, None], thresholds)
                if thresholds is not None else torch.zeros_like(mean))
    return torch.stack([
        -sf_acq.ucb(mean, var, kappa),
        -sf_acq.pi(mean, var, f_best),
        -sf_acq.ei(mean, var, f_best),
        -feasible,
        mean,
        sf_acq.mean_sigma_ratio(mean, var),
    ], dim=1)


def mace_select(posterior_fn: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
                bounds, f_best: float, generator: Optional[torch.Generator] = None,
                n_candidates: int = 512, thresholds: Optional[Sequence[float]] = None,
                device="cuda") -> np.ndarray:
    """Sample candidates from ``generator``, filter the Pareto front of the
    acquisition ensemble and pick a uniformly random front member (from the
    same generator); returns ``(1, d)``."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    lo, hi = box(bounds, resolve_device(device))
    xs = uniform(generator, (n_candidates, lo.shape[0]), lo, hi)
    with torch.no_grad():
        mean, var = posterior_fn(xs)
        front = torch.nonzero(pareto_mask(mace_objectives(mean, var, f_best, thresholds)))[:, 0]
    pick = front[int(torch.randint(front.shape[0], (), generator=generator))]
    return xs[pick].reshape(1, -1).cpu().numpy()
