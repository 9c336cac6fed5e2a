"""Operations of a GAR fit over HOGP stages at a cell's shapes, counted
from the Kronecker algebra and not from the program: the same count
whether the spectrum is tracked or decomposed exactly each step, and
whether the backward is closed-form or autograd's.  A multiply-add is two
operations.

A stage has n rows and fields of shape (d_1, .., d_M); its modes are
(n, d_1, .., d_M) and its targets hold N = n d_1 .. d_M elements.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

from portbench.counts import gram_flops

# NVIDIA H100 SXM, dense float64 on the tensor cores, at its full 700 W
# (NVIDIA's data sheet): the Grams and eigendecompositions run in float64
PEAK_FP64 = 67e12
EIGH = 9  # a symmetric eigendecomposition with its vectors, 9 n^3 (Golub & Van Loan)


def rotate_flops(dims: Sequence[int]) -> float:
    """One mode product on every mode of an N-element tensor, each by a
    d_m x d_m matrix: sum over the modes of 2 N d_m."""
    N = math.prod(dims)
    return float(sum(2 * N * d for d in dims))


def lift_flops(n: int, l_shape: Sequence[int], h_shape: Sequence[int]) -> float:
    """The lift of n fields from ``l_shape`` onto ``h_shape``, mode by mode
    (mode m maps l_m to h_m, the modes before it already lifted)."""
    total, cur = 0.0, list(l_shape)
    for m, h in enumerate(h_shape):
        total += 2 * n * h * math.prod(cur)
        cur[m] = h
    return total


def hogp_nll_flops(n: int, shape: Sequence[int], d: int) -> float:
    """The NLML's value: the Grams (K_0 over d inputs, each mode's over a
    1-d grid), each mode's eigendecomposition (9 d_m^3), the targets
    rotated into the eigenbasis, and A, its log and T^2 / A (3 N)."""
    dims = (n, *shape)
    grams = gram_flops(n, n, d) + sum(gram_flops(k, k, 1) for k in shape)
    eigh = sum(EIGH * k ** 3 for k in dims)
    return grams + eigh + rotate_flops(dims) + 3 * math.prod(dims)


def hogp_step_flops(n: int, shape: Sequence[int], d: int,
                    l_shape: Optional[Sequence[int]] = None) -> float:
    """One restart's NLML and gradient: `hogp_nll_flops`, each Gram's
    cotangent (G G^T, 2 N d_m, then V D V^T, 4 d_m^3), the noise's and the
    Grams' own gradient terms (3 N, and as many operations as each Gram
    took again); a residual stage (``l_shape`` given) adds its lift, the
    lift's backward (twice the lift) and the targets' cotangent rotated out
    of the eigenbasis."""
    dims = (n, *shape)
    N = math.prod(dims)
    grams = gram_flops(n, n, d) + sum(gram_flops(k, k, 1) for k in shape)
    total = hogp_nll_flops(n, shape, d) + grams + 3 * N
    total += sum(2 * N * k + 4 * k ** 3 for k in dims)
    if l_shape is not None:
        total += 3 * lift_flops(n, l_shape, shape) + rotate_flops(dims)
    return total


def hogp_posterior_flops(n: int, shape: Sequence[int], d: int, m: int) -> float:
    """The stage's state (`hogp_nll_flops` and Sigma^-1 Y rotated back) and
    its mean and per-element variance at m points: the cross Gram, the
    mean's mode products, (k(x*, X) V_0)^2 (2 m n^2) and (K_m V_m)^2
    (2 d_m^3), and the explained variance's mode products."""
    dims = (n, *shape)
    P = math.prod(shape)
    state = hogp_nll_flops(n, shape, d) + rotate_flops(dims)
    modes = sum(2 * m * P * k for k in shape)
    mean = 2 * m * n * P + modes
    var = 2 * m * n * n + sum(2 * k ** 3 for k in shape) + 2 * m * n * P + modes
    return state + gram_flops(m, n, d) + mean + var


def gar_fit_flops(rows: Sequence[int], shapes: Sequence[Sequence[int]], d: int, restarts: int,
                  steps: int, n_test: int) -> float:
    """A whole GAR fit: every stage's restarts x steps, its winner's check
    (one NLML), its state and posterior at the test points, and at each
    residual stage the final residual's lift and the cascade's lift of the
    lower stage's mean and variance."""
    total = 0.0
    for s, (n, shape) in enumerate(zip(rows, shapes)):
        l_shape = shapes[s - 1] if s else None
        total += restarts * steps * hogp_step_flops(n, shape, d, l_shape)
        total += hogp_nll_flops(n, shape, d) + hogp_posterior_flops(n, shape, d, n_test)
        if l_shape is not None:
            total += lift_flops(n, l_shape, shape) + 2 * lift_flops(n_test, l_shape, shape)
    return total
