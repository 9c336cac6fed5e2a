"""Operations and bytes of the model's algebra at a cell's shapes, and the
published peaks they are held against.

Counts follow the mathematics, not the port's implementation: the same
work is counted whether a kernel or a library call does it, the spectrum
is tracked or exact, the NLML blocked or fused.  Every count is in floating
point operations (a multiply-add is two) or bytes.
"""

from __future__ import annotations

from typing import Sequence

# NVIDIA H100 SXM, dense, at its full 700 W (NVIDIA's data sheet)
PEAK_FP32 = 67e12  # FLOP/s outside the tensor cores (the port runs no TF32)
PEAK_HBM = 3.35e12  # bytes/s
PANEL = 64  # the Cholesky kernels' diagonal block (their Wd output)


def gram_flops(n1: int, n2: int, d: int) -> float:
    """An SE Gram: per pair d differences, d products and d sums over the
    scaled inputs, then the scale, the exponential and the variance."""
    return n1 * n2 * (3 * d + 3)


def cigp_step_flops(n: int, d: int) -> float:
    """One restart's NLML and gradient at n rows: the Cholesky (n^3/3), the
    inverse the gradient needs (inv(L) n^3/3, then inv(L)^T inv(L) n^3/3),
    the Gram, and the gradient's elementwise terms (forming Sigma^-1 -
    alpha alpha^T and contracting it with the three parameter derivatives
    of the Gram, 8 n^2)."""
    return n ** 3 + gram_flops(n, n, d) + 8 * n * n


def cigp_export_flops(n: int, d: int) -> float:
    """A stage's posterior cache: the Gram, the Cholesky and inv(L) (2 n^3/3)
    and alpha (two triangular products, 2 n^2)."""
    return 2 * n ** 3 / 3 + gram_flops(n, n, d) + 2 * n * n


def cigp_predict_flops(n: int, m: int, d: int) -> float:
    """Mean and diagonal variance at m points from the cache: the cross
    Gram, inv(L) K_s (2 n^2 m), the squares summed (2 n m) and K_s^T alpha
    (2 n m)."""
    return gram_flops(n, m, d) + 2 * n * n * m + 4 * n * m


def ar_fit_flops(rows: Sequence[int], d: int, restarts: int, steps: int,
                 n_test: int) -> float:
    """A whole AR fit: every stage's restarts x steps, its winner's check
    (one NLML), its export, and the top fidelity's posterior at the test
    points through every stage."""
    total = 0.0
    for n in rows:
        total += restarts * steps * cigp_step_flops(n, d) + cigp_step_flops(n, d)
        total += cigp_export_flops(n, d) + cigp_predict_flops(n, n_test, d)
    return total


def chol_cost(b: int, n: int) -> tuple:
    """(FLOPs, bytes) of one K2/K3a launch on ``(b, n, n)``: the Cholesky
    (n^3/3) and its 64x64 diagonal blocks' inverses (n/64 of 64^3/3 each);
    A's lower triangle read, L's lower triangle and the blocks' inverses
    written, float32."""
    flops = b * (n ** 3 / 3 + (n / PANEL) * PANEL ** 3 / 3)
    tri = n * (n + 1) / 2
    nbytes = 4 * b * (tri + tri + n * PANEL)
    return flops, nbytes


def tri_inv_cost(b: int, n: int) -> tuple:
    """(FLOPs, bytes) of one K3b launch: W = inv(L) (n^3/3); L's lower
    triangle and the diagonal blocks' inverses read, W's lower triangle
    written, float32."""
    flops = b * n ** 3 / 3
    tri = n * (n + 1) / 2
    nbytes = 4 * b * (tri + n * PANEL + tri)
    return flops, nbytes


def bound_s(flops: float, nbytes: float, peak_flops: float = PEAK_FP32) -> float:
    """The least time the card could take: the larger of the operations
    over the peak rate and the bytes over the memory bandwidth."""
    return max(flops / peak_flops, nbytes / PEAK_HBM)
