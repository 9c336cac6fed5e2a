"""CAR-large, the joint form of ContinuAR (Xing et al., "ContinuAR:
Continuous Autoregression For Infinite-Fidelity Fusion", NeurIPS 2023;
IceLab-X/FidelityFusion `FidelityFusion_Models/
CAR_ContinuousAutoRegression_Large.py`), in plain PyTorch, float64, TF32
off (`gar.no_tf32`).

One GP over the stacked rows ``[x, s]`` of every fidelity, ``s = i + 1``
at fidelity i, each fidelity's x and y normalized by its own statistics
(FidelityFusion's normalizers: x per column, y over all elements, std with
ddof 1).  The kernel

    k([x, s], [x', s']) = |sv| F(s, s') |sv_x| exp(-0.5 |x / l - x' / l|^2),
    l = |ls| + 1e-9 per input column,

with ContinuAR's double integral over the fidelity variable

    F(s1, s2) = int_0^s1 int_0^s2 e^{-b (s1 - z1)} e^{-b (s2 - z2)}
                exp(-0.5 (z1 - z2)^2 / l_z^2) dz1 dz2,   l_z = |lz| + 1e-3.

Noise ``max(nv^2, 1e-4 m)`` and a relative nugget ``1e-4 m``, m the mean of
K's diagonal: ``Sigma = K + (max(nv^2, 1e-4 m) + 1e-4 m) I``.  NLML
``0.5 y^T Sigma^-1 y + sum log diag chol(Sigma) + 0.5 n log 2 pi`` through
``torch.linalg.cholesky``; gradients by autograd; the posterior at test
inputs of the top fidelity, without the noise, as GPBasic predicts.

Departures from the published model, each also the program's:
- F is estimated through a feature map, not by the plain Monte-Carlo mean
  over z that ContinuAR's code takes: Bochner's theorem writes the SE
  factor as ``E_w cos(w (z1 - z2) / l_z)`` over ``w ~ N(0, 1)``, and the
  substitution ``z = s t`` turns each inner integral into
  ``s E_t[e^{-b s (1 - t)} (cos, sin)(w s t / l_z)]`` over ``t ~ U(0, 1)``.
  The draws ``w`` (64) and ``t`` (64) are the model's data, made here as
  the program makes them (`draws`), from the configuration's ``mc_seed``.
  The exponent is capped at 20.
- The fidelity indicator is ``s = i + 1``, so no fidelity sits at s = 0,
  where every feature vanishes.

Parameters are dicts of float64 tensors: ``ls`` (d,), ``sv_x``, ``lz``,
``sv``, ``b``, ``nv``, each a scalar.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch

from portbench.reference.cigp import Norm

LOG2PI = math.log(2.0 * math.pi)
NUGGET = 1e-4  # relative jitter, times the mean of K's diagonal
MIN_NOISE = 1e-4  # the noise floor, times the mean of K's diagonal
LS_EPS = 1e-9
LZ_EPS = 1e-3
MAX_EXPONENT = 20.0


class CARData:
    """The stacked training set in float64 from raw per-fidelity (x, y):
    each fidelity normalized by its own statistics, its rows given the
    column ``s = i + 1``, lowest fidelity first."""

    def __init__(self, xs: Sequence[np.ndarray], ys: Sequence[np.ndarray]):
        xs = [np.asarray(x, np.float64) for x in xs]
        ys = [np.asarray(y, np.float64).reshape(len(x), -1) for x, y in zip(xs, ys)]
        self.norms = [Norm(x, y) for x, y in zip(xs, ys)]
        self.x = np.concatenate([np.concatenate([nm.x(x), np.full((len(x), 1), i + 1.0)], 1)
                                 for i, (nm, x) in enumerate(zip(self.norms, xs))])
        self.y = np.concatenate([nm.y(y) for nm, y in zip(self.norms, ys)])

    def test_inputs(self, x_test) -> np.ndarray:
        """Raw test inputs normalized by the top fidelity's statistics, with
        its ``s``."""
        top = len(self.norms)
        xt = self.norms[-1].x(x_test)
        return np.concatenate([xt, np.full((len(xt), 1), float(top))], 1)


def draws(seed: int, n_features: int, n_mc: int):
    """The Monte-Carlo draws ``(w, t)`` in float64: from a CPU
    ``torch.Generator`` seeded with ``seed``, ``n_features`` standard
    normal frequencies, then ``n_mc`` uniform points on [0, 1), both drawn
    in float32."""
    gen = torch.Generator().manual_seed(seed)
    w = torch.randn((n_features,), generator=gen)
    t = torch.rand((n_mc,), generator=gen)
    return w.to(torch.float64), t.to(torch.float64)


def features(p, s, w, t):
    """``phi(s)`` (n, 2 n_w): ``s mean_t[e^{-b s (1 - t)} (cos, sin)(w s t /
    l_z)] / sqrt(n_w)``, so that ``phi(s1) . phi(s2)`` estimates F."""
    lz = torch.abs(p["lz"]) + LZ_EPS
    z = s[:, None] * t[None, :]  # (n, T): z = s t
    decay = torch.exp(torch.clamp(-p["b"] * (s[:, None] - z), max=MAX_EXPONENT))
    arg = z[:, :, None] * w[None, None, :] / lz  # (n, T, W)
    c = s[:, None] * (decay[:, :, None] * torch.cos(arg)).mean(1)
    si = s[:, None] * (decay[:, :, None] * torch.sin(arg)).mean(1)
    return torch.cat([c, si], -1) / math.sqrt(w.shape[0])


def kernel(p, x1, x2, w, t):
    """The joint Gram between stacked inputs ``[x, s]``."""
    f1 = features(p, x1[:, -1], w, t)
    f2 = f1 if x2 is x1 else features(p, x2[:, -1], w, t)
    ls = torch.abs(p["ls"]) + LS_EPS
    a, b = x1[:, :-1] / ls, x2[:, :-1] / ls
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    return torch.abs(p["sv"]) * (f1 @ f2.T) * torch.abs(p["sv_x"]) * torch.exp(-0.5 * d2)


def sigma(p, x, w, t):
    K = kernel(p, x, x, w, t)
    m = K.diagonal().mean()
    noise = torch.maximum(p["nv"] ** 2, MIN_NOISE * m)
    return K + (noise + NUGGET * m) * torch.eye(len(x), dtype=K.dtype, device=K.device)


def nll(p, x, y, w, t):
    """The joint NLML (a scalar); ``y`` (n, 1)."""
    L = torch.linalg.cholesky(sigma(p, x, w, t))
    a = torch.linalg.solve_triangular(L, y, upper=False)
    return 0.5 * (a * a).sum() + torch.log(L.diagonal()).sum() + 0.5 * y.numel() * LOG2PI


def posterior(p, x, y, xt, w, t):
    """Posterior mean (m,) and variance (m,) at stacked test inputs ``xt``,
    without the noise, in normalized units."""
    L = torch.linalg.cholesky(sigma(p, x, w, t))
    Ks = kernel(p, x, xt, w, t)
    v = torch.linalg.solve_triangular(L, Ks, upper=False)
    alpha = torch.cholesky_solve(y, L)
    k_ss = kernel(p, xt, xt, w, t).diagonal()
    return (Ks.T @ alpha)[:, 0], k_ss - (v * v).sum(0)


def params(values: Dict[str, object], device) -> Dict[str, torch.Tensor]:
    """Float64 tensors of ``values`` (numbers or arrays) on ``device``."""
    return {k: torch.as_tensor(np.asarray(v, np.float64), device=device)
            for k, v in values.items()}
