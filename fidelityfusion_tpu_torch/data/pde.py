"""Multi-fidelity PDE field data (Poisson / heat), numpy and scipy only.

A copy of `fidelityfusion_tpu/data/pde.py` (the port imports nothing of the
JAX package): a parametrized 2-D Poisson problem solved on nested grid
resolutions, where the grid resolution is the fidelity.

    -Laplace(u) = f_theta(x, y)  on [0,1]^2,   u = 0 on the boundary
    f_theta = sum of Gaussian sources parametrized by theta (the GP input)

Low fidelity = coarse grid (smooth, biased solution); high fidelity =
fine grid.  Solves are dense Cholesky factor-once/solve-many per grid.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
from scipy.linalg import cho_factor, cho_solve


def _laplacian_2d(n: int) -> np.ndarray:
    """Dense 5-point Laplacian (Dirichlet) for an n x n interior grid."""
    h = 1.0 / (n + 1)
    I = np.eye(n)
    T = 2.0 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)
    A = (np.kron(I, T) + np.kron(T, I)) / h**2
    return A


def _source(theta: np.ndarray, n: int) -> np.ndarray:
    """Gaussian-bump source field on the n x n interior grid.

    theta = (cx, cy, width, amplitude) per bump, flattened; values are
    mapped into sensible ranges from raw inputs in [0, 1].
    """
    g = (np.arange(1, n + 1)) / (n + 1)
    X, Y = np.meshgrid(g, g, indexing="ij")
    theta = np.atleast_1d(theta).ravel()
    n_bumps = max(1, len(theta) // 4)
    f = np.zeros((n, n))
    for b in range(n_bumps):
        cx, cy, w, a = (list(theta[4 * b : 4 * b + 4]) + [0.5, 0.5, 0.5, 1.0])[:4]
        cx = 0.2 + 0.6 * cx
        cy = 0.2 + 0.6 * cy
        w = 0.05 + 0.2 * w
        a = 0.5 + 1.5 * a
        f += a * np.exp(-((X - cx) ** 2 + (Y - cy) ** 2) / (2 * w**2))
    return f


def poisson_fields(
    x: np.ndarray, resolutions: Sequence[int] = (8, 16, 32)
) -> List[np.ndarray]:
    """Solve the Poisson problem for each parameter row at each resolution.

    x: (n_samples, d) with d >= 4 read as Gaussian-source parameters in
    [0,1].  Returns a list (one per fidelity) of (n_samples, r, r) fields.
    """
    x = np.atleast_2d(np.asarray(x, np.float64))
    out = []
    for r in resolutions:
        A = _laplacian_2d(r)
        cf = cho_factor(A)
        fields = np.empty((len(x), r, r))
        for i, theta in enumerate(x):
            f = _source(theta, r).ravel()
            fields[i] = cho_solve(cf, f).reshape(r, r)
        out.append(fields.astype(np.float32))
    return out


def generate_poisson_mf_dataset(
    n_samples: int = 160,
    resolutions: Sequence[int] = (8, 16, 32),
    d_in: int = 4,
    seed: int = 0,
) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Sample random source parameters and produce multi-fidelity fields —
    the stand-in for the reference's `Poisson_data/{input,output_fidelity_i}.npy`.
    """
    rng = np.random.default_rng(seed)
    x = rng.random((n_samples, d_in))
    ys = poisson_fields(x, resolutions)
    return x.astype(np.float32), ys


def heat_fields(
    x: np.ndarray,
    resolutions: Sequence[int] = (8, 16, 32),
    t_final: float = 0.02,
) -> List[np.ndarray]:
    """Implicit-Euler heat equation from a parametrized initial condition;
    solution field at t_final per resolution (second PDE family for the
    experiment suite)."""
    x = np.atleast_2d(np.asarray(x, np.float64))
    out = []
    for r in resolutions:
        A = _laplacian_2d(r)
        n_steps = 10
        dt = t_final / n_steps
        M = np.eye(r * r) + dt * A
        cf = cho_factor(M)
        fields = np.empty((len(x), r, r))
        for i, theta in enumerate(x):
            u = _source(theta, r).ravel()
            for _ in range(n_steps):
                u = cho_solve(cf, u)
            fields[i] = u.reshape(r, r)
        out.append(fields.astype(np.float32))
    return out
