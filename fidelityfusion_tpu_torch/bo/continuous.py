"""Continuous-fidelity acquisition strategies.

Port of `fidelityfusion_tpu/bo/continuous.py`: fidelity z lives in an
interval, and the choice of z balances the information gap

    xi(z)    = sqrt(1 - phi(z)^2),  phi = SE correlation between z and z = 1
    gamma(z) = sqrt(k_0) * xi(z) * (cost(z)/cost(1))^q,  q = 1/(p + d + 2).

`ContinuousFidelityUCB` optimizes x by multi-start Adam on the
top-fidelity UCB, then picks the SMALLEST z whose posterior std still
exceeds gamma(z) and whose information gap is large enough (else z_min).
`ContinuousFidelityES` is max-value entropy search per unit cost over a
joint (x, z) candidate grid; `continuous_best_observed_kg` the
best-observed knowledge gradient through the joint posterior;
`ContinuousFidelityKG` the retrain-per-candidate KG.

Random draws (z grids, candidate grids, Adam starts, MC draws) come from
CPU ``torch.Generator``s seeded from ``seed`` with the JAX strategies'
offsets; the grids are attributes (``z_range``, ``xs``, ``zs``,
``grid``) and the function takes ``draws``, so given arrays (the JAX
package's, in the tests) can stand in for them.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from fidelityfusion_tpu_torch.bo.acq import fantasy_normal, norm_pdf
from fidelityfusion_tpu_torch.bo.optimize import optimize_acqf
from fidelityfusion_tpu_torch.utils.device import resolve_device


class ContinuousFidelityUCB:
    """MF-GP-UCB with continuous fidelities.  ``posterior_fn(x, z) ->
    (mean, var)`` with x ``(n, d)`` and z a scalar; ``cost`` follows
    `data/cost.py:ContinuousCost`."""

    def __init__(self, x_dimension: int, search_range, posterior_fn: Callable, cost,
                 seed: int = 0, beta: float = 1.0, k_0: float = 1.0, p: float = 1.0,
                 z_grid_size: int = 100, length_scale_z: float = 1.0, device="cuda"):
        self.x_dimension = x_dimension
        self.search_range = search_range
        self.posterior_fn = posterior_fn
        self.cost = cost
        self.beta = beta
        self.k_0 = k_0
        self.p = p
        self.length_scale_z = length_scale_z
        z_lo, z_hi = search_range[-1]
        u = torch.rand((z_grid_size,), generator=torch.Generator().manual_seed(seed)).numpy()
        self.z_range = np.sort(u * (z_hi - z_lo) + z_lo)
        self.seed = seed
        self.device = resolve_device(device)

    def information_gap(self, z) -> np.ndarray:
        """xi(z) = sqrt(1 - phi(z)^2), phi the SE correlation with z = 1."""
        z = np.asarray(z, float).reshape(-1)
        phi = np.exp(-0.5 * ((z - 1.0) / self.length_scale_z) ** 2)
        return np.sqrt(np.maximum(1.0 - phi ** 2, 0.0))

    def gamma_z(self, xi_z: np.ndarray) -> np.ndarray:
        q = 1.0 / (self.p + self.x_dimension + 2.0)
        lam = np.power(self.cost.compute_cost(self.z_range) / self.cost.compute_cost(1.0), q)
        return np.sqrt(self.k_0) * xi_z * lam.reshape(-1)

    def compute_next(self, generator: Optional[torch.Generator] = None, steps: int = 20,
                     lr: float = 0.01, x0=None) -> Tuple[np.ndarray, float]:
        """Optimize x on the top-fidelity UCB (8 starts from ``generator``,
        seeded ``seed + 10086`` if None, or ``x0``), then scan the z grid.
        Returns (x (1, d), z)."""
        if generator is None:
            generator = torch.Generator().manual_seed(self.seed + 10086)
        z_top = float(self.search_range[-1][-1])

        def acq(x):
            mean, var = self.posterior_fn(x, z_top)
            return (mean + self.beta * var).reshape(-1)

        new_x, _ = optimize_acqf(acq, self.search_range[: self.x_dimension], generator,
                                 raw_samples=8, steps=steps, lr=lr, x0=x0, device=self.device)
        new_x = new_x.detach().reshape(1, -1)
        stds = []
        with torch.no_grad():
            for z in self.z_range:
                _, v = self.posterior_fn(new_x, float(z))
                stds.append(float(np.sqrt(max(float(v.reshape(-1)[0]), 0.0))))
        xi = self.information_gap(self.z_range)
        gamma = self.gamma_z(xi)
        xi_floor = self.information_gap(np.sqrt(self.p))[0] / np.sqrt(self.beta)
        candidates = [z for z, s_z, x_z, g_z in zip(self.z_range, stds, xi, gamma)
                      if s_z > g_z and x_z > xi_floor]
        new_z = float(min(candidates)) if candidates else float(self.search_range[-1][0])
        return new_x.cpu().numpy(), new_z


def _candidate_grid(generator: torch.Generator, search_range, x_dimension: int, n: int):
    """Random x candidates (float32) and sorted z candidates, paired by
    index; x drawn first, then z."""
    bounds = np.asarray(search_range[:x_dimension], float)
    xs = torch.rand((n, x_dimension), generator=generator).numpy()
    xs = xs * (bounds[:, 1] - bounds[:, 0]) + bounds[:, 0]
    z_lo, z_hi = search_range[-1]
    zs = np.sort(torch.rand((n,), generator=generator).numpy() * (z_hi - z_lo) + z_lo)
    return xs.astype(np.float32), zs


class ContinuousFidelityES:
    """Max-value entropy search over continuous fidelities: candidate
    (x_i, z_i) scores phi(z_i)^2 * alpha(x_i) / cost(z_i), with

        alpha(x) = E_{y*}[gamma phi(gamma) / (2 Phi(gamma)) - log Phi(gamma)],
        gamma    = (y* - mu_top(x)) / sigma_top(x),

    y* MC samples of the top-fidelity maximum over the grid (``n_mc``
    normal draws from a generator seeded ``seed + 131``, or ``eps``)."""

    def __init__(self, x_dimension: int, search_range, posterior_fn: Callable, cost,
                 seed: int = 0, n_candidates: int = 100, n_mc: int = 128,
                 length_scale_z: float = 1.0, cost_aware: bool = True, maximize: bool = False,
                 device="cuda"):
        self.x_dimension = x_dimension
        self.search_range = search_range
        self.posterior_fn = posterior_fn
        self.cost = cost
        self.seed = seed
        self.n_mc = n_mc
        self.length_scale_z = length_scale_z
        self.cost_aware = cost_aware
        self.maximize = maximize
        self.device = resolve_device(device)
        self.xs, self.zs = _candidate_grid(torch.Generator().manual_seed(seed), search_range,
                                           x_dimension, n_candidates)

    def compute_next(self, eps: Optional[torch.Tensor] = None) -> Tuple[np.ndarray, float]:
        z_top = float(self.search_range[-1][-1])
        with torch.no_grad():
            mean, var = self.posterior_fn(torch.as_tensor(self.xs, device=self.device), z_top)
        mean = mean.reshape(-1)
        if not self.maximize:  # mirror so the formulas maximize
            mean = -mean
        std = torch.sqrt(torch.clamp(var.reshape(-1), min=1e-12))
        if eps is None:
            eps = fantasy_normal((self.n_mc, mean.shape[0]),
                                 torch.Generator().manual_seed(self.seed + 131), mean)
        eps = torch.as_tensor(eps, dtype=mean.dtype, device=mean.device)
        y_star = (mean[None, :] + std[None, :] * eps).max(dim=1).values  # (M,)
        gamma = torch.clamp((y_star[None, :] - mean[:, None]) / std[:, None], -6.0, 10.0)
        cdf = torch.clamp(torch.special.ndtr(gamma), min=1e-10)
        alpha = (gamma * norm_pdf(gamma) / (2.0 * cdf) - torch.log(cdf)).mean(dim=1)
        zs = torch.as_tensor(self.zs, dtype=mean.dtype, device=mean.device)
        phi = torch.exp(-0.5 * ((zs - z_top) / self.length_scale_z) ** 2)
        scores = (phi ** 2 * alpha).cpu().numpy()
        if self.cost_aware:
            scores = scores / np.maximum(self.cost.compute_cost(self.zs), 1e-9)
        j = int(np.argmax(scores))
        return self.xs[j].reshape(1, -1), float(self.zs[j])


def continuous_best_observed_kg(mean_cov_fn: Callable, search_range, cost, incumbent: float,
                                seed: int = 0, n_candidates: int = 48, n_grid: int = 64,
                                n_draws: int = 24, is_last: bool = False,
                                draws: Optional[Dict] = None,
                                device="cuda") -> Tuple[np.ndarray, float]:
    """Continuous-fidelity knowledge gradient on the best-OBSERVED value:
    candidate (x_i, z_i) scores

        (E_e[max(max(inc, y_e), max_grid mu_e^top)] - V_now) / cost(z_i),

    mu_e^top the z = 1 posterior mean over an x grid after the rank-1
    fantasy update through the joint (x, z) posterior covariance; on the
    final budget iteration the score is E[max(inc, y_e)] - inc.

    ``mean_cov_fn(xz (m, d+1)) -> (mean (m,), cov (m, m))`` is the joint
    posterior (e.g. `FIDES.predict_full`).  Draws, from a generator seeded
    ``seed + 86`` in this order, or given in ``draws``: candidates ``xs``
    ``(n_candidates, d)`` and ``zs``, the grid ``grid`` ``(n_grid, d)``,
    the fantasies ``eps`` ``(n_draws,)``."""
    device = resolve_device(device)
    draws = draws or {}
    gen = torch.Generator().manual_seed(seed + 86)
    d = len(search_range) - 1
    xs, zs = _candidate_grid(gen, search_range, d, n_candidates)
    grid, _ = _candidate_grid(gen, search_range, d, n_grid)
    eps = torch.randn((n_draws,), generator=gen)
    xs = np.asarray(draws.get("xs", xs), np.float32)
    zs = np.asarray(draws.get("zs", zs))
    grid = np.asarray(draws.get("grid", grid), np.float32)
    eps = torch.as_tensor(np.asarray(draws.get("eps", eps), np.float32), device=device)
    z_top = float(search_range[-1][-1])

    cand_xz = np.concatenate([xs, zs.reshape(-1, 1).astype(np.float32)], axis=1)
    grid_xz = np.concatenate([grid, np.full((n_grid, 1), z_top, np.float32)], axis=1)
    all_xz = torch.as_tensor(np.concatenate([grid_xz, cand_xz], axis=0), device=device)
    with torch.no_grad():
        mu, C = mean_cov_fn(all_xz)
    mu = mu.reshape(-1)
    mu_grid, mu_cand = mu[:n_grid], mu[n_grid:]
    var_c = torch.clamp(torch.diagonal(C)[n_grid:], min=1e-10)
    std_c = torch.sqrt(var_c)
    # any-z observation counts: (n_draws, n_cand)
    vals = torch.clamp(mu_cand[None, :] + eps[:, None] * std_c[None, :], min=incumbent)
    if not is_last:
        w = C[:n_grid, n_grid:] / var_c[None, :]  # (n_grid, n_cand) Kalman rows
        shifted = mu_grid[None, :, None] + eps[:, None, None] * std_c[None, None, :] * w[None]
        vals = torch.maximum(vals, shifted.max(dim=1).values)
    vals = vals.mean(0).cpu().numpy()
    base = incumbent if is_last else max(incumbent, float(mu_grid.max()))
    costs = np.maximum(np.asarray(cost.compute_cost(zs)).reshape(-1), 1e-9)
    scores = (vals - base) / (np.ones_like(costs) if is_last else costs)
    j = int(np.argmax(scores))
    return xs[j].reshape(1, -1), float(zs[j])


class ContinuousFidelityKG:
    """Continuous-fidelity knowledge gradient by retraining: random (x, z)
    candidates; per candidate the caller's ``fantasy_max_fn(x (1, d), z)``
    returns the max top-fidelity posterior mean over a reference grid after
    adding the fantasized observation; the gain over the current max per
    unit cost picks the candidate.  Candidates from a generator seeded
    ``seed + 86``, the grid from one seeded ``seed + 117``."""

    def __init__(self, x_dimension: int, search_range, posterior_fn: Callable,
                 fantasy_max_fn: Callable, cost, seed: int = 0, n_candidates: int = 20,
                 n_grid: int = 100, device="cuda"):
        self.x_dimension = x_dimension
        self.search_range = search_range
        self.posterior_fn = posterior_fn
        self.fantasy_max_fn = fantasy_max_fn
        self.cost = cost
        self.seed = seed
        self.device = resolve_device(device)
        self.xs, self.zs = _candidate_grid(torch.Generator().manual_seed(seed + 86),
                                           search_range, x_dimension, n_candidates)
        self.grid, _ = _candidate_grid(torch.Generator().manual_seed(seed + 117),
                                       search_range, x_dimension, n_grid)

    def compute_next(self) -> Tuple[np.ndarray, float]:
        z_top = float(self.search_range[-1][-1])
        with torch.no_grad():
            mean, _ = self.posterior_fn(torch.as_tensor(self.grid, device=self.device), z_top)
        base = float(mean.max())
        best, new_x, new_z = -np.inf, self.xs[0:1], float(self.zs[0])
        for i in range(len(self.zs)):
            x_i = self.xs[i].reshape(1, -1)
            after = float(self.fantasy_max_fn(x_i, float(self.zs[i])))
            kg = (after - base) / max(float(self.cost.compute_cost(self.zs[i])), 1e-9)
            if kg > best:
                best, new_x, new_z = kg, x_i, float(self.zs[i])
        return new_x, new_z
