"""Operations of a CAR-large fit at a cell's shapes, counted from the
model's algebra and not from the program: the same count whichever kernel
or library call does the work.  A multiply-add is two operations.

The joint GP has n stacked rows of d inputs plus the fidelity column, a
feature map of n_w frequencies and n_t Monte-Carlo draws (2 n_w features),
and predicts at m test inputs of the top fidelity.
"""

from __future__ import annotations

from typing import Sequence

from portbench.counts import gram_flops

FEATURE_OPS = 9  # per (row, draw, frequency): the phase (3), cos, sin, the decay's two products, two sums


def feature_flops(n: int, n_w: int, n_t: int) -> float:
    """phi(s) at n rows: the phase, its cosine and sine, the decay and the
    means over the draws (the decay itself, n n_t, is left out)."""
    return FEATURE_OPS * n * n_t * n_w


def joint_gram_flops(n1: int, n2: int, d: int, n_w: int) -> float:
    """The joint Gram of n1 x n2 inputs: phi(s1) phi(s2)^T (2 n1 n2 2 n_w),
    the base SE Gram and the two products of the Hadamard form."""
    return 2 * n1 * n2 * 2 * n_w + gram_flops(n1, n2, d) + 2 * n1 * n2


def car_step_flops(n: int, d: int, n_w: int, n_t: int) -> float:
    """One Adam step's NLML and gradient at n rows: the feature map and its
    cotangent, the joint Gram and its cotangent (phi's, 2 n^2 2 n_w, the
    base Gram's parameter terms, as many as the Gram took, the Hadamard
    terms, 3 n^2), then the Cholesky, the inverse and the Sigma^-1 gradient
    at n^3/3 each and the gradient's elementwise terms (8 n^2, as
    `counts.cigp_step_flops` counts them)."""
    grads = feature_flops(n, n_w, n_t) + 2 * n * n * 2 * n_w + gram_flops(n, n, d) + 3 * n * n
    return (feature_flops(n, n_w, n_t) + joint_gram_flops(n, n, d, n_w) + grads
            + n ** 3 + 8 * n * n)


def car_forward_flops(n: int, m: int, d: int, n_w: int, n_t: int) -> float:
    """`forward` at m test inputs: the training Gram, its Cholesky and
    inverse (2 n^3/3), alpha (two triangular products, 2 n^2), the cross
    and test Grams with the test inputs' features, W K_s (2 n^2 m), the
    mean (2 n m) and the covariance K_ss - v^T v (2 m^2 n)."""
    grams = (feature_flops(n, n_w, n_t) + joint_gram_flops(n, n, d, n_w)
             + feature_flops(m, n_w, n_t) + joint_gram_flops(n, m, d, n_w)
             + joint_gram_flops(m, m, d, n_w))
    return grams + 2 * n ** 3 / 3 + 2 * n * n + 2 * n * n * m + 2 * n * m + 2 * m * m * n


def car_fit_flops(rows: Sequence[int], d: int, n_w: int, n_t: int, steps: int,
                  n_test: int) -> float:
    """A whole fit: ``steps`` Adam steps over every fidelity's rows stacked,
    then `forward` at the test inputs."""
    n = sum(rows)
    return steps * car_step_flops(n, d, n_w, n_t) + car_forward_flops(n, n_test, d, n_w, n_t)
