"""cfKG: cost-aware discrete-fidelity knowledge gradient (one-step lookahead).

Port of `fidelityfusion_tpu/bo/cfkg.py`.  The knowledge gradient is taken
for the quantity the MFBO protocol records, the best observed top-fidelity
value, with a two-step lookahead: query (x, s) now at cost(s), then one
further top-fidelity query at the updated posterior argmax.  Under the
fantasy draw e the terminal value is

    V_e = max(incumbent_e, max_x' mu_e^top(x')),

``incumbent_e = max(incumbent, y_e)`` at the top fidelity (the draw is an
observed top value) and ``incumbent`` below it, and ``mu_e^top`` the
top-fidelity posterior mean after the exact rank-1 update

    mu_e^top(x') = mu^top(x') + cov(f_top(x'), y(x,s)) / var(y(x,s)) * (y_e - mu(x,s)).

On the final budget iteration there is no future query: V_e =
incumbent_e.  The score is ``(E_e[V_e] - V_now) / cost(s)``.
``retrain_gain`` keeps the retrain-per-candidate semantics (append and
recompute the full posterior) as `fantasy_gain`'s parity counterpart.

Draws: the fantasy ``eps`` and the candidates are given (the JAX
package's, in the tests) or drawn from a CPU ``torch.Generator``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from fidelityfusion_tpu_torch.bo.acq import fantasy_normal
from fidelityfusion_tpu_torch.bo.optimize import box, uniform
from fidelityfusion_tpu_torch.utils.device import resolve_device


def best_observed_kg_scores(mu_top: torch.Tensor, mu_s: torch.Tensor, cov_s: torch.Tensor,
                            cross_scale: float, incumbent: float, cost_s: float, is_top: bool,
                            is_last: bool, n_draws: int = 24,
                            eps: Optional[torch.Tensor] = None,
                            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Best-observed KG score of every grid point as the candidate, at one
    fidelity s, for all ``n_draws`` draws ``eps`` at once.

    mu_top, mu_s: ``(n,)`` top- and fidelity-s posterior means on the grid;
    cov_s: ``(n, n)`` fidelity-s posterior covariance (column i is
    cov(f_s(grid), f_s(x_i))); cross_scale: c with cov(f_top(x'), f_s(x)) =
    c * cov_s(x', x).  Returns ``(n,)`` per-cost scores."""
    if eps is None:
        eps = fantasy_normal((n_draws,), generator, mu_top)
    eps = eps.to(mu_top.device, mu_top.dtype)
    var_c = torch.clamp(torch.diagonal(cov_s), min=1e-10)
    std_c = torch.sqrt(var_c)
    w = cross_scale * cov_s / var_c[None, :]  # Kalman rows: w[:, i] for candidate i
    if is_top:
        # the observed top draw at each candidate: (K, n)
        inc = torch.clamp(mu_s[None, :] + eps[:, None] * std_c[None, :], min=incumbent)
    else:
        inc = torch.full((eps.shape[0], mu_top.shape[0]), incumbent,
                         dtype=mu_top.dtype, device=mu_top.device)
    if is_last:
        vals = inc
        base = incumbent
    else:
        # max over the grid of mu_top + e std_i w[:, i] for each (draw, candidate)
        shifted = mu_top[None, :, None] + eps[:, None, None] * std_c[None, None, :] * w[None]
        vals = torch.maximum(inc, shifted.max(dim=1).values)
        base = max(incumbent, float(mu_top.max()))
    return (vals.mean(0) - base) / cost_s


def cfkg_select(mean_fn: Callable, cov_full_fn: Callable, cross_scale_fn: Callable[[int], float],
                bounds, fidelity_num: int, cost_fn: Callable[[int], float], incumbent: float,
                generator: Optional[torch.Generator] = None, n_candidates: int = 64,
                is_last: bool = False, n_draws: int = 24, candidates=None, eps=None,
                device="cuda") -> Tuple[np.ndarray, int]:
    """Random-candidate cfKG argmax over (x, s): score every (candidate,
    fidelity) pair by the per-cost best-observed KG and return the best
    ``(x (1, d), s)``.  ``candidates`` ``(n_candidates, d)`` and ``eps``
    ``(n_draws,)`` (one draw set shared by every fidelity) default to
    draws from ``generator``, candidates first."""
    lo, hi = box(bounds, resolve_device(device))
    if candidates is None:
        candidates = uniform(generator, (n_candidates, lo.shape[0]), lo, hi)
    xs = torch.as_tensor(candidates, dtype=torch.float32, device=lo.device)
    if eps is None:
        eps = fantasy_normal((n_draws,), generator, xs)
    top = fidelity_num - 1
    mu_top = mean_fn(xs, top).reshape(-1)
    best_score, best_i, best_s = -np.inf, 0, top
    for s in range(fidelity_num):
        mu_s = mu_top if s == top else mean_fn(xs, s).reshape(-1)
        scores = best_observed_kg_scores(
            mu_top, mu_s, cov_full_fn(xs, s), float(cross_scale_fn(s)), float(incumbent),
            float(cost_fn(s + 1)), is_top=(s == top), is_last=is_last, n_draws=n_draws,
            eps=eps)
        i = int(torch.argmax(scores))
        v = float(scores[i])
        if v > best_score:
            best_score, best_i, best_s = v, i, s
    return xs[best_i: best_i + 1].detach().cpu().numpy(), best_s


def retrain_gain(gp, params, x_train, y_train, x_cand, x_grid, cost_s: float,
                 n_draws: int = 16, eps: Optional[torch.Tensor] = None) -> float:
    """Parity-mode KG: per fantasy draw, APPEND the imagined observation to
    the training set and recompute the FULL posterior over the grid (exact
    conditioning in place of the reference's refit).  With the same draws
    (default: a generator seeded 0, as `fantasy_gain`) the two scorers
    agree to linear-algebra roundoff."""
    with torch.no_grad():
        mu_c, var_c = gp.predict_diag(params, x_train, y_train, x_cand)
        mu_c = mu_c.reshape(-1)[0]
        std_c = torch.sqrt(torch.clamp(var_c.reshape(-1)[0], min=1e-12))
        base_mu, _ = gp.predict_diag(params, x_train, y_train, x_grid)
        if eps is None:
            eps = fantasy_normal((n_draws,), None, mu_c)
        x_aug = torch.cat([x_train, x_cand], dim=0)
        maxes = []
        for e in eps.to(mu_c.device, mu_c.dtype):
            y_aug = torch.cat([y_train.reshape(-1, 1), (mu_c + e * std_c).reshape(1, 1)], dim=0)
            mu_k, _ = gp.predict_diag(params, x_aug, y_aug, x_grid)
            maxes.append(mu_k.max())
        return float((torch.stack(maxes).mean() - base_mu.max()) / cost_s)


def fantasy_gain(mean_fn: Callable, var_fn: Callable, cov_fn: Callable, x_cand, s: int,
                 x_grid, cost_s: float, eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-fidelity fantasy KG over a grid (per-cost gain in the max
    posterior mean at fidelity s), the rank-1 analogue of `retrain_gain`.
    ``cov_fn(a, b, s) -> (n_a, n_b)`` is the posterior cross-covariance;
    ``eps`` ``(16,)`` defaults to a generator seeded 0."""
    mu_grid = mean_fn(x_grid, s).reshape(-1)
    var_c = var_fn(x_cand, s).reshape(-1)[0]
    cov_row = cov_fn(x_grid, x_cand, s).reshape(-1)
    std_c = torch.sqrt(torch.clamp(var_c, min=1e-12))
    weights = cov_row / torch.clamp(var_c, min=1e-12)
    if eps is None:
        eps = fantasy_normal((16,), None, mu_grid)
    eps = eps.to(mu_grid.device, mu_grid.dtype)
    fantasized = mu_grid[None, :] + eps[:, None] * std_c * weights[None, :]
    return (fantasized.max(dim=1).values.mean() - mu_grid.max()) / cost_s
