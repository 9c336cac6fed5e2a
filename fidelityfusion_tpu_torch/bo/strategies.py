"""Per-strategy discrete multi-fidelity BO classes with ``compute_next()``.

Port of `fidelityfusion_tpu/bo/strategies.py`; each strategy wraps
per-fidelity posterior closures (torch tensors in, torch tensors out) and
returns the next ``(x (1, d) numpy, fidelity)`` query.

* `MFUCBStrategy`: MF-GP-UCB, random-candidate argmax of per-fidelity
  UCB with beta = 0.2 d log(t + 1.1); the ladder escalates while
  beta * var > gamma.
* `MFEIStrategy`: EI at the top fidelity by multi-start Adam; fidelity by
  the per-cost variance reduction ``cost_i / (sigma^2_before -
  sigma^2_after)`` from a caller's one-step retrain closure.
* `MFESStrategy`: entropy search, p(argmax) over a candidate grid by MC
  Thompson sampling, the candidate whose collapsed std leaves the least
  entropy; fidelity by the information-gap rule gamma(s) = sqrt(k0) *
  xi(s) * (cost(s)/cost(top))^q, xi(s) = sqrt(1 - corr(f_s, f_top)^2).
* `CFKGStrategy`: per-cost best-observed knowledge gradient
  (`bo/cfkg.py`).

Random draws: each strategy draws its candidates and normal draws from a
CPU ``torch.Generator`` seeded from its ``seed`` (the JAX strategy's key
offset), in the order `draws` lists them; ``compute_next(draws=...)``
takes them given instead (the JAX package's, in the tests).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from fidelityfusion_tpu_torch.bo import acq as sf_acq
from fidelityfusion_tpu_torch.bo.cfkg import cfkg_select
from fidelityfusion_tpu_torch.bo.optimize import box, optimize_acqf, uniform
from fidelityfusion_tpu_torch.utils.device import resolve_device


def _bounds(bounds, x_dimension):
    return (np.asarray(bounds, float) if bounds is not None
            else np.tile([0.0, 1.0], (x_dimension, 1)))


def _given(draws: Optional[Dict], key: str, device):
    if draws is None or key not in draws:
        return None
    return torch.as_tensor(np.asarray(draws[key], np.float32), device=device)


class MFUCBStrategy:
    def __init__(self, x_dimension: int, fidelity_num: int,
                 posterior_fn: Callable,  # (x, s) -> (mean (n,), var (n,))
                 iteration: int = 0, gamma: float = 0.01, seed: int = 0,
                 n_candidates: int = 100, bounds=None, device="cuda"):
        self.x_dimension = x_dimension
        self.fidelity_num = fidelity_num
        self.posterior_fn = posterior_fn
        self.beta = 0.2 * x_dimension * math.log(iteration + 1.1)
        self.gamma = gamma
        self.seed = seed
        self.n_candidates = n_candidates
        self.bounds = _bounds(bounds, x_dimension)
        self.device = resolve_device(device)

    def compute_next(self, draws: Optional[Dict] = None) -> Tuple[np.ndarray, int]:
        """``draws``: optional ``{"xs": (n_candidates, d)}``."""
        lo, hi = box(self.bounds, self.device)
        xs = _given(draws, "xs", self.device)
        if xs is None:
            gen = torch.Generator().manual_seed(self.seed + 1007)
            xs = uniform(gen, (self.n_candidates, self.x_dimension), lo, hi)
        with torch.no_grad():
            scores = []
            for s in range(self.fidelity_num):
                mean, var = self.posterior_fn(xs, s)
                scores.append(mean.reshape(-1) + self.beta * var.reshape(-1))
            flat = int(torch.argmax(torch.stack(scores)))
            new_x = xs[flat % xs.shape[0]].reshape(1, -1)
            # fidelity ladder: the lowest s whose uncertainty is still large
            for s in range(self.fidelity_num):
                _, v = self.posterior_fn(new_x, s)
                if self.beta * float(torch.max(v)) > self.gamma:
                    return new_x.cpu().numpy(), s
        return new_x.cpu().numpy(), self.fidelity_num - 1


class MFEIStrategy:
    def __init__(self, x_dimension: int, fidelity_num: int, posterior_fn: Callable,
                 cost_fn: Callable[[int], float], retrain_variance_fn: Optional[Callable] = None,
                 f_best: float = 0.0, seed: int = 0, bounds=None, device="cuda"):
        """``retrain_variance_fn(x, s) -> sigma2_after``: the top-fidelity
        posterior variance at x after fantasizing an observation at (x, s).
        If None, the fidelity is 0."""
        self.x_dimension = x_dimension
        self.fidelity_num = fidelity_num
        self.posterior_fn = posterior_fn
        self.cost_fn = cost_fn
        self.retrain_variance_fn = retrain_variance_fn
        self.f_best = f_best
        self.seed = seed
        self.bounds = _bounds(bounds, x_dimension)
        self.device = resolve_device(device)

    def compute_next(self, draws: Optional[Dict] = None) -> Tuple[np.ndarray, int]:
        """``draws``: optional ``{"x0": (16, d)}`` Adam starts."""
        top = self.fidelity_num - 1

        def ei_top(x):
            mean, var = self.posterior_fn(x, top)
            return sf_acq.ei(mean.reshape(-1), var.reshape(-1), self.f_best)

        x_star, _ = optimize_acqf(
            ei_top, self.bounds, torch.Generator().manual_seed(self.seed + 10086),
            raw_samples=16, steps=60, lr=0.1, x0=_given(draws, "x0", self.device),
            device=self.device)
        new_x = x_star.reshape(1, -1)
        if self.retrain_variance_fn is None:
            return new_x.cpu().numpy(), 0
        with torch.no_grad():
            _, var_before = self.posterior_fn(new_x, top)
        s2_before = float(torch.max(var_before))
        new_x = new_x.cpu().numpy()
        best_mark, new_s = float("inf"), top
        for s in range(self.fidelity_num):
            s2_after = float(self.retrain_variance_fn(new_x, s))
            mark = self.cost_fn(s + 1) / max(s2_before - s2_after, 1e-12)
            if mark < best_mark:
                best_mark, new_s = mark, s
        return new_x, new_s


class MFESStrategy:
    def __init__(self, x_dimension: int, fidelity_num: int, posterior_fn: Callable,
                 cost_fn: Callable[[int], float],
                 cross_scale_fn: Optional[Callable[[int], float]] = None, seed: int = 0,
                 n_candidates: int = 64, n_mc: int = 64, is_last: bool = False, bounds=None,
                 device="cuda"):
        """``cross_scale_fn(s) -> c`` with cov(f_top(x), f_s(x)) = c *
        var_s(x), used by the information gap xi(s); default 1."""
        self.x_dimension = x_dimension
        self.fidelity_num = fidelity_num
        self.posterior_fn = posterior_fn
        self.cost_fn = cost_fn
        self.cross_scale_fn = cross_scale_fn or (lambda s: 1.0)
        self.seed = seed
        self.n_candidates = n_candidates
        self.n_mc = n_mc
        self.is_last = is_last
        self.bounds = _bounds(bounds, x_dimension)
        self.device = resolve_device(device)

    @staticmethod
    def _pmax_entropy(mean, std, eps):
        """MC estimate of the entropy of p(argmax) over the grid from the
        normal draws ``eps`` ``(n_mc, n)``; ``std`` ``(*batch, n)`` gives
        one entropy per batch row."""
        samples = mean + std[..., None, :] * eps  # (*batch, n_mc, n)
        hits = torch.nn.functional.one_hot(samples.argmax(dim=-1), mean.shape[-1])
        counts = hits.sum(dim=-2) + 1e-3
        p = counts / counts.sum(dim=-1, keepdim=True)
        return -(p * torch.log(p)).sum(dim=-1)

    def compute_next(self, draws: Optional[Dict] = None) -> Tuple[np.ndarray, int]:
        """``draws``: optional ``{"xs": (n_candidates, d), "eps": (n_mc,
        n_candidates)}`` (the normal draws of the entropy after a
        candidate's std collapses, shared by every candidate)."""
        lo, hi = box(self.bounds, self.device)
        gen = torch.Generator().manual_seed(self.seed + 31)
        xs = _given(draws, "xs", self.device)
        if xs is None:
            xs = uniform(gen, (self.n_candidates, self.x_dimension), lo, hi)
        top = self.fidelity_num - 1
        with torch.no_grad():
            mean, var = self.posterior_fn(xs, top)
        mean = mean.reshape(-1)
        std = torch.sqrt(torch.clamp(var.reshape(-1), min=1e-12))
        if self.is_last:
            # final budget iteration: cash in at the posterior argmax, top fidelity
            return xs[int(torch.argmax(mean))].reshape(1, -1).cpu().numpy(), top
        n = xs.shape[0]
        eps = _given(draws, "eps", self.device)
        if eps is None:
            eps = sf_acq.fantasy_normal((self.n_mc, n), gen, mean)
        # expected entropy after observing candidate j ~= the entropy with
        # its std collapsed to a tenth (row j of std_new)
        std_new = std.repeat(n, 1)
        std_new.diagonal().mul_(0.1)
        j_star = int(torch.argmin(self._pmax_entropy(mean, std_new, eps)))
        new_x = xs[j_star].reshape(1, -1)
        return new_x.cpu().numpy(), self._information_gap_fidelity(new_x, float(std.max()))

    def _information_gap_fidelity(self, new_x, std_scale) -> int:
        """gamma(s) = sqrt(k0) * xi(s) * (cost(s)/cost(top))^q, xi(s) =
        sqrt(1 - corr(f_s, f_top)^2), q = 1/(p + d + 2) with p = 1: the
        cheapest fidelity whose posterior std at new_x exceeds gamma(s),
        else the top."""
        top = self.fidelity_num - 1
        xj = torch.as_tensor(new_x, dtype=torch.float32, device=self.device)
        q = 1.0 / (1 + self.x_dimension + 2)
        k0 = max(std_scale, 1e-6) ** 2
        with torch.no_grad():
            v_top = float(torch.max(self.posterior_fn(xj, top)[1]))
        cost_top = float(self.cost_fn(top + 1))
        for s in range(top):
            with torch.no_grad():
                v_s = float(torch.max(self.posterior_fn(xj, s)[1]))
            c = float(self.cross_scale_fn(s))
            denom = math.sqrt(max(v_s * v_top, 1e-18))
            corr = min(abs(c) * v_s / denom, 1.0) if denom > 0 else 0.0
            xi = math.sqrt(max(1.0 - corr ** 2, 0.0))
            gamma_s = math.sqrt(k0) * xi * (float(self.cost_fn(s + 1)) / cost_top) ** q
            if math.sqrt(max(v_s, 0.0)) > gamma_s:
                return s
        return top


class CFKGStrategy:
    def __init__(self, x_dimension: int, fidelity_num: int, mean_fn: Callable,
                 cov_full_fn: Callable, cost_fn: Callable[[int], float], incumbent: float,
                 cross_scale_fn: Optional[Callable[[int], float]] = None, seed: int = 0,
                 n_candidates: int = 64, is_last: bool = False, bounds=None, device="cuda"):
        """``mean_fn(x, s) -> (n,)``; ``cov_full_fn(x, s) -> (n, n)``;
        ``cross_scale_fn(s) -> c`` with cov(f_top(x'), f_s(x)) = c *
        cov_s(x', x); ``incumbent`` the best observed top-fidelity y;
        ``is_last`` the final budget iteration (`bo/cfkg.py`)."""
        self.mean_fn = mean_fn
        self.cov_full_fn = cov_full_fn
        self.cross_scale_fn = cross_scale_fn or (lambda s: 1.0)
        self.fidelity_num = fidelity_num
        self.cost_fn = cost_fn
        self.incumbent = incumbent
        self.seed = seed
        self.n_candidates = n_candidates
        self.is_last = is_last
        self.bounds = _bounds(bounds, x_dimension)
        self.device = resolve_device(device)

    def compute_next(self, draws: Optional[Dict] = None) -> Tuple[np.ndarray, int]:
        """``draws``: optional ``{"xs": (n_candidates, d), "eps": (24,)}``."""
        with torch.no_grad():
            return cfkg_select(
                self.mean_fn, self.cov_full_fn, self.cross_scale_fn, self.bounds,
                self.fidelity_num, self.cost_fn, self.incumbent,
                torch.Generator().manual_seed(self.seed + 77), n_candidates=self.n_candidates,
                is_last=self.is_last, candidates=_given(draws, "xs", self.device),
                eps=_given(draws, "eps", self.device), device=self.device)
