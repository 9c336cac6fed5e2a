"""The Poisson fields of the program's `data/pde.py` (`poisson_fields`,
the stand-in for the reference's `Poisson_data`), its formulas copied:

    -Laplace(u) = f_theta  on [0, 1]^2,  u = 0 on the boundary,
    f_theta = a exp(-|p - c|^2 / (2 w^2)),  theta = (cx, cy, w, a) in [0, 1]^4

on an r x r interior grid by the dense 5-point Laplacian, one Cholesky
factor per resolution.  Every right-hand side of a resolution is solved in
one call, where the program solves them one by one: the same factor and
the same triangular solves.  Fields come back float32, as the program's.
"""

from __future__ import annotations

import numpy as np
from scipy.linalg import cho_factor, cho_solve


def _laplacian_2d(r: int) -> np.ndarray:
    h = 1.0 / (r + 1)
    eye = np.eye(r)
    T = 2.0 * np.eye(r) - np.eye(r, k=1) - np.eye(r, k=-1)
    return (np.kron(eye, T) + np.kron(T, eye)) / h ** 2


def _sources(theta: np.ndarray, r: int) -> np.ndarray:
    """(n, r * r) Gaussian-bump sources of (n, 4) parameters in [0, 1]."""
    g = np.arange(1, r + 1) / (r + 1)
    X, Y = np.meshgrid(g, g, indexing="ij")
    cx, cy = 0.2 + 0.6 * theta[:, 0], 0.2 + 0.6 * theta[:, 1]
    w, a = 0.05 + 0.2 * theta[:, 2], 0.5 + 1.5 * theta[:, 3]
    d2 = (X[None] - cx[:, None, None]) ** 2 + (Y[None] - cy[:, None, None]) ** 2
    f = a[:, None, None] * np.exp(-d2 / (2 * w[:, None, None] ** 2))
    return f.reshape(len(theta), r * r)


def fields(x: np.ndarray, r: int) -> np.ndarray:
    """(n, r, r) float32 solutions for the rows of ``x`` ((n, 4), in
    [0, 1]) on the r x r grid."""
    x = np.atleast_2d(np.asarray(x, np.float64))[:, :4]
    if len(x) == 0:
        return np.zeros((0, r, r), np.float32)
    u = cho_solve(cho_factor(_laplacian_2d(r)), _sources(x, r).T)
    return u.T.reshape(len(x), r, r).astype(np.float32)
