"""The 41-function analytic multi-fidelity benchmark zoo (a numpy copy of
`fidelityfusion_tpu/data/zoo.py`; the port imports nothing of the JAX
package, and its outputs equal that module's bit for bit).

Re-design of `assets/MF_data/collected_data.py:4-1509`
(formulas documented in `assets/MF_data/MF_data_readme.md:1-363`):
uniform API

    multi_fidelity_<name>(x=None, *, num_points=200, seed=0, **kw)
        -> (x, [y_fid0, y_fid1, ...])          # ordered LOW -> HIGH*

(*except ``forrester_my`` whose reference order is [f1..f4] with f1 the
Forrester high-fidelity function, kept for loader compatibility with the
fidelity-pair naming `forrester12` etc., `Experiments/Load_Mfdata.py:243-253`).

Implemented in numpy with explicit `numpy.random.Generator` seeding (the
reference draws torch global-RNG noise inside the P-family functions):
the zoo is host-side data generation, not the compute path.  `ZOO` maps
names to (function, x_dim, n_fidelities) for the experiment loader.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import numpy as np

TwoF = Tuple[np.ndarray, List[np.ndarray]]


def _x_or_sample(x, num_points, d, lo, hi, seed):
    if x is None:
        rng = np.random.default_rng(seed)
        x = rng.random((num_points, d)) * (hi - lo) + lo
    return np.atleast_2d(np.asarray(x, float))


def _col(v):
    return np.asarray(v, float).reshape(-1, 1)


# --------------------------------------------------------------- forrester
def multi_fidelity_forrester_my(x=None, *, num_points=200, seed=0, std=0.0) -> TwoF:
    """Forrester 4-fidelity family (`collected_data.py:4-50`); order
    [f1, f2, f3, f4] with f1 = (6x-2)^2 sin(12x-4) (the HF function)."""
    x = _x_or_sample(x, num_points, 1, 0.0, 1.0, seed)
    f1 = (6 * x - 2) ** 2 * np.sin(12 * x - 4)
    f2 = (5.5 * x - 2.5) ** 2 * np.sin(12 * x - 4)
    f3 = 0.75 * f1 + 5 * (x - 0.5) - 2
    f4 = 0.5 * f1 + 10 * (x - 0.5) - 5
    if std > 0:
        rng = np.random.default_rng(seed + 1)
        f1, f2, f3, f4 = (f + rng.standard_normal(f.shape) * std for f in (f1, f2, f3, f4))
    return x, [f1, f2, f3, f4]


def multi_fidelity_non_linear_sin(x=None, *, num_points=200, seed=0) -> TwoF:
    """f_low = sin(8 pi x); f_high = (x - sqrt(2)) f_low^2, x in [-5, 10]."""
    x = _x_or_sample(x, num_points, 1, -5.0, 10.0, seed)
    y_l = np.sin(8 * np.pi * x)
    y_h = (x - math.sqrt(2.0)) * y_l**2
    return x, [y_l, y_h]


def multi_fidelity_Colville(x=None, *, num_points=200, seed=0, A=0.5) -> TwoF:
    """4-D Colville; low fidelity evaluates HF at A^2 x minus a quadratic."""
    x = _x_or_sample(x, num_points, 4, 0.0, 1.0, seed)

    def high(z):
        x1, x2, x3, x4 = z.T
        return _col(
            100 * (x1**2 - x2) ** 2
            + (x1 - 1) ** 2
            + (x3 - 1) ** 2
            + 90 * (x3**2 - x4)
            + 10.1 * ((x2 - 1) ** 2 + (x4 - 1) ** 2)
            + 19.8 * (x2 - 1) * (x4 - 1)
        )

    x1, x2, x3, x4 = x.T
    low = high(A * A * x) - _col((A + 0.5) * (5 * x1**2 + 4 * x2**2 + 3 * x3**2 + x4**2))
    return x, [low, high(x)]


def multi_fidelity_Toal(x=None, *, num_points=200, seed=0, A=0.5) -> TwoF:
    """10-D Toal (2015)."""
    x = _x_or_sample(x, num_points, 10, -100.0, 100.0, seed)
    hi = np.sum((x - 1) ** 2, axis=1) - np.sum(x[:, 1:] * x[:, :-1], axis=1)
    cross = np.sum(
        np.arange(1, 10) * x[:, 1:] * x[:, :-1], axis=1
    )
    lo = np.sum((x - A) ** 2, axis=1) - (A - 0.65) * cross
    return x, [_col(lo), _col(hi)]


# ------------------------------------------------------ P1-P5 (Pellegrini)
def _p_noise(rng, vals, amp, weight):
    if amp == 0:
        return vals
    R = vals.max() - vals.min()
    return vals + rng.standard_normal(vals.shape) * amp * R * weight


def multi_fidelity_p1_simp(x=None, *, num_points=200, seed=0, A=0.0) -> TwoF:
    x = _x_or_sample(x, num_points, 1, -3.0, 2.0, seed)
    rng = np.random.default_rng(seed + 1)
    x1 = x[:, 0]
    w = 1 / (1 + np.exp(32 * (x1 + 0.5)))
    hi = np.sin(30 * (x1 - 0.9) ** 4) * np.cos(2 * (x1 - 0.9)) + (x1 - 0.9) / 2
    mid = (hi - 1 + x1) / (1 + 0.25 * x1)
    lo = (
        np.sin(20 * (x1 - 0.87) ** 4) * np.cos(2 * (x1 - 0.87))
        + (x1 - 0.87) / 2
        - (2.5 - (0.7 * x1 - 0.14) ** 2)
        + 2 * x1
    )
    out = [_p_noise(rng, v, A, w) for v in (lo, mid, hi)]
    return x, [_col(v) for v in out]


def multi_fidelity_p2_simp(x=None, *, num_points=200, seed=0, A=0.0) -> TwoF:
    x = _x_or_sample(x, num_points, 1, 0.0, 1.0, seed)
    rng = np.random.default_rng(seed + 1)
    x1 = x[:, 0]
    w = 1 / (1 + np.exp(-32 * (x1 + 0.5)))
    hi = np.sin(30 * (x1 - 0.9) ** 4) * np.cos(2 * (x1 - 0.9)) + (x1 - 0.9) / 2
    mid = (hi - 1 + x1) / (1 + 0.25 * x1)
    lo = (
        np.sin(20 * (x1 - 0.87) ** 4) * np.cos(2 * (x1 - 0.87))
        + (x1 - 0.87) / 2
        - (2.5 - (0.7 * x1 - 0.14) ** 2)
        + 2 * x1
    )
    out = [_p_noise(rng, v, A, w) for v in (lo, mid, hi)]
    return x, [_col(v) for v in out]


def multi_fidelity_p3_simp(x=None, *, num_points=200, seed=0, A=0.0) -> TwoF:
    x = _x_or_sample(x, num_points, 2, -2.0, 2.0, seed)
    rng = np.random.default_rng(seed + 1)
    x1, x2 = x.T
    w = 1 / (1 + np.exp(32 * (x1 + 0.5)))
    hi = 100 * (x2 - x1**2) ** 2 + (1 - x1) ** 2
    mid = 50 * (x2 - x1**2) ** 2 + (-2 - x1) ** 2 - 0.5 * (x1 + x2)
    lo = (hi - 4 - 0.5 * (x1 + x2)) / (10 + 0.25 * (x1 + x2))
    out = [_p_noise(rng, v, A, w) for v in (lo, mid, hi)]
    return x, [_col(v) for v in out]


def multi_fidelity_p4_simp(x=None, *, num_points=200, seed=0, A=0.0) -> TwoF:
    x = _x_or_sample(x, num_points, 2, -6.0, 5.0, seed)
    rng = np.random.default_rng(seed + 1)
    x1, x2 = x.T
    w = 1 / (1 + np.exp(32 * (x1 + 0.5)))
    hi = (x1**2 + x2**2) / 25 - np.cos(x1) * np.cos(x2 / math.sqrt(2)) + 1
    mid = np.cos(x1) * np.cos(x2 / math.sqrt(2)) + 1
    lo = (x1**2 + x2**2) / 20 - np.cos(x1 / math.sqrt(2)) * np.cos(x2 / math.sqrt(3)) - 1
    out = [_p_noise(rng, v, A, w) for v in (lo, mid, hi)]
    return x, [_col(v) for v in out]


def multi_fidelity_p5_simp(x=None, *, num_points=200, seed=0, A=0.0) -> TwoF:
    x = _x_or_sample(x, num_points, 2, -0.2, -0.1, seed)
    rng = np.random.default_rng(seed + 1)
    x1 = x[:, 0]
    w = 1 / (1 + np.exp(-128 * (x1 - 0.05)))
    hi = np.sum(x**2 + 1 - np.cos(10 * np.pi * x), axis=1)

    def err(phi):
        th = 1 - 0.0001 * phi
        return np.sum(
            th * np.cos(10 * np.pi * th * x + 0.5 * np.pi * th + np.pi) ** 2, axis=1
        )

    mid = hi + err(5000)
    lo = hi + err(2500)
    out = [_p_noise(rng, v, A, w) for v in (hi, mid, lo)]
    # reference order: [test_1(=HF formula), test_2(phi=5000), test_3(phi=2500)]
    return x, [_col(v) for v in out]


# ------------------------------------------------------------ maolin family
def multi_fidelity_maolin1(x=None, *, num_points=200, seed=0) -> TwoF:
    x = _x_or_sample(x, num_points, 1, 0.0, 1.0, seed)
    xx = np.where(np.abs(x) < 1e-9, 1e-9, x)
    hi = np.sin(10 * np.pi * xx) / (2 * xx) + (x - 1) ** 4
    lo = np.sin(10 * np.pi * xx) / xx + 2 * (x - 1) ** 4
    return x, [lo, hi]


def multi_fidelity_maolin5(x=None, *, num_points=200, seed=0) -> TwoF:
    x = _x_or_sample(x, num_points, 2, 0.0, 5.0, seed)
    x1, x2 = x.T
    hi = (
        (x2 - 5.1 * x1**2 / (4 * np.pi**2) + 5.1 * x1 / np.pi - 6) ** 2
        + 10 * (1 - 0.125 * np.pi) * np.cos(x1)
        + 10
    )
    lo = (1 - 0.125 * np.pi) * np.cos(x1)
    return x, [_col(lo), _col(hi)]


def multi_fidelity_maolin6(x=None, *, num_points=200, seed=0) -> TwoF:
    x = _x_or_sample(x, num_points, 2, 0.0, 5.0, seed)
    x1, x2 = x.T
    hi = 101 * x1**2 + 101 * (x1**2 + x2**2) ** 2
    lo = x1**2 + 100 * (x1**2 + x2**2) ** 4
    return x, [_col(lo), _col(hi)]


def multi_fidelity_maolin7(x=None, *, num_points=200, seed=0) -> TwoF:
    x = _x_or_sample(x, num_points, 2, -5.0, 10.0, seed)
    x1, x2 = x.T
    a = (1 - 0.2 * x2 + 0.05 * np.sin(4 * np.pi * x2 - x1)) ** 2
    b = (x2 - 0.5 * np.sin(2 * np.pi * x1)) ** 2
    return x, [_col(a + 4 * b), _col(a + b)]


def multi_fidelity_maolin8(x=None, *, num_points=200, seed=0) -> TwoF:
    x = _x_or_sample(x, num_points, 2, 0.0, 1.0, seed)
    x1, x2 = x.T
    hi = (
        (1.5 - x1 + x1 * x2) ** 2
        + (2.25 - x1 + x1 * x2**2) ** 2
        + (2.625 - x1 + x1 * x2**3) ** 2
    )
    lo = (1.5 - x1 + x1 * x2) ** 2 + x1 + x2
    return x, [_col(lo), _col(hi)]


def multi_fidelity_maolin10(x=None, *, num_points=200, seed=0) -> TwoF:
    x = _x_or_sample(x, num_points, 2, 0.0, 0.5, seed)

    def hi_fn(z):
        x1, x2 = z.T
        x2s = np.where(np.abs(x2) < 1e-9, 1e-9, x2)
        return (1 - np.exp(-1 / (2 * x2s))) * (
            2300 * x1**3 + 1900 * x1**2 + 2092 * x2 + 60
        ) / (100 * x1**3 + 500 * x1**2 + 4 * x2 + 20)

    x1, x2 = x.T
    shift = lambda a, b: np.stack([x1 + a, np.maximum(0, x2 + b)], axis=1)
    lo = -0.4 * hi_fn(shift(0.05, 0.05)) + 0.25 * (
        hi_fn(shift(0.05, -0.05)) + hi_fn(shift(-0.05, 0.05)) + hi_fn(shift(-0.05, -0.05))
    )
    return x, [_col(lo), _col(hi_fn(x))]


def multi_fidelity_maolin12(x=None, *, num_points=200, seed=0) -> TwoF:
    x = _x_or_sample(x, num_points, 2, -2.0, 2.0, seed)
    x1, x2 = x.T
    hi = x1 * np.exp(-(x1**2) - x2**2)
    lo = hi + x1 / 10
    return x, [_col(lo), _col(hi)]


def multi_fidelity_maolin13(x=None, *, num_points=200, seed=0) -> TwoF:
    x = _x_or_sample(x, num_points, 2, -1.0, 1.0, seed)
    x1, x2 = x.T
    hi = np.exp(x1 + x2) * np.cos(x1 * x2)
    lo = hi + np.cos(x1**2 + x2**2)
    return x, [_col(lo), _col(hi)]


def multi_fidelity_maolin15(x=None, *, num_points=200, seed=0) -> TwoF:
    x = _x_or_sample(x, num_points, 3, 0.0, 1.0, seed)
    xs = np.where(np.abs(x) < 1e-9, 1e-9, x)
    e = np.exp(-2.0 / xs**1.75)
    hi = 100 * (e[:, 0] + e[:, 1] + e[:, 2])
    lo = 100 * (e[:, 0] + e[:, 1] + 0.2 * e[:, 2])
    return x, [_col(lo), _col(hi)]


def multi_fidelity_maolin19(x=None, *, num_points=200, seed=0) -> TwoF:
    x = _x_or_sample(x, num_points, 6, -5.0, 10.0, seed)
    hi = np.sum(
        100 * (x[:, 1:] - x[:, :-1] ** 2) ** 2 + (x[:, :-1] - 1) ** 2, axis=1
    )
    lo = np.sum(
        100 * (x[:, 1:] - x[:, :-1]) ** 2 + 4 * (x[:, :-1] - 1) ** 4, axis=1
    )
    return x, [_col(lo), _col(hi)]


def multi_fidelity_maolin20(x=None, *, num_points=200, seed=0) -> TwoF:
    x = _x_or_sample(x, num_points, 8, 0.0, 1.0, seed)
    x1, x2, x3 = x[:, 0], x[:, 1], x[:, 2]
    base = 4 * (x1 - 2 + 8 * x2 - 8 * x2**2) ** 2 + (3 - 4 * x2) ** 2
    pre = 16 * np.sqrt(x3 + 1) * (2 * x3 - 1) ** 2

    def tail(weighted):
        s = np.zeros(len(x))
        for i in range(3, 8):  # i = 4..8 1-based
            inner = np.sum(x[:, 2 : i + 1], axis=1)
            w = (i + 1) if weighted else 1.0
            s = s + w * np.log(1 + inner)
        return s

    hi = base + pre * tail(True)
    lo = base + pre * tail(False)
    return x, [_col(lo), _col(hi)]


# -------------------------------------------------------------- shuo family
def multi_fidelity_shuo6(x=None, *, num_points=200, seed=0) -> TwoF:
    if x is None:
        rng = np.random.default_rng(seed)
        x = np.stack(
            [rng.random(num_points) * 15 - 5, rng.random(num_points) * 15], axis=1
        )
    x = np.atleast_2d(np.asarray(x, float))
    x1, x2 = x.T
    core = (x2 - 1.275 * (x1 / np.pi) ** 2 + 5 * x1 / np.pi - 6) ** 2
    cosx = 10 * (1 - 1 / (8 * np.pi)) * np.cos(x1)
    return x, [_col(0.5 * core + cosx), _col(core + cosx)]


def multi_fidelity_shuo11(x=None, *, num_points=200, seed=0) -> TwoF:
    x = _x_or_sample(x, num_points, 3, -1.0, 1.0, seed)
    s = np.sin(16.0 / 15.0 * x - 1)
    hi = np.sum(0.3 * s + s**2, axis=1)
    lo = np.sum(0.3 * s + 0.2 * s**2, axis=1)
    return x, [_col(lo), _col(hi)]


def multi_fidelity_shuo15(x=None, *, num_points=200, seed=0) -> TwoF:
    x = _x_or_sample(x, num_points, 8, 0.0, 1.0, seed)

    def f(z, c):
        s = np.zeros(len(z))
        for i in range(2):
            a, b, cc, d = z[:, 4 * i], z[:, 4 * i + 1], z[:, 4 * i + 2], z[:, 4 * i + 3]
            s = s + (a + 10 * b) ** 2 + c * (cc - d) ** 2 + (b - 2 * cc) ** 4 + 10 * (a - d) ** 4
        return s

    return x, [_col(f(x, 125.0)), _col(f(x, 5.0))]


def multi_fidelity_shuo16(x=None, *, num_points=200, seed=0) -> TwoF:
    x = _x_or_sample(x, num_points, 10, -2.0, 3.0, seed)
    A = np.array([-6.089, -17.164, -34.054, -5.914, -24.721, -14.986, -24.100, -10.708, -26.662, -22.662])
    B = np.array([-10.0, -10, -20, -10, -20, -20, -20, -10, -20, -20])
    ex = np.exp(x)
    lse = np.log(np.sum(ex, axis=1, keepdims=True))
    hi = np.sum(ex * (A[None, :] + x - lse), axis=1)
    lo = np.sum(ex * (B[None, :] + x - lse), axis=1)
    return x, [_col(lo), _col(hi)]


# --------------------------------------- test_function_d1..d10 (tl1..tl10)
def test_function_d1(x=None, *, num_points=200, seed=0) -> TwoF:
    x = _x_or_sample(x, num_points, 1, 0.0, 1.0, seed)
    hi = (6 * x - 2) ** 2 * np.sin(12 * x - 4)
    lo = 0.56 * hi + 10 * (x - 0.5) - 5
    return x, [lo, hi]


def test_function_d2(x=None, *, num_points=200, seed=0) -> TwoF:
    x = _x_or_sample(x, num_points, 1, 0.0, 1.0, seed)
    lo = np.sin(2 * np.pi * (x - 0.1))
    hi = lo + x**2
    return x, [lo, hi]


def test_function_d3(x=None, *, num_points=200, seed=0) -> TwoF:
    x = _x_or_sample(x, num_points, 1, 0.0, 10.0, seed)
    hi = x * np.sin(x) / 10
    lo = hi + x / 10
    return x, [lo, hi]


def test_function_d4(x=None, *, num_points=200, seed=0) -> TwoF:
    x = _x_or_sample(x, num_points, 1, 0.0, 1.0, seed)
    hi = np.cos(3.5 * np.pi * x) * np.exp(-1.4 * x)
    lo = hi + 0.75 * x**2
    return x, [lo, hi]


def test_function_d5(x=None, *, num_points=200, seed=0) -> TwoF:
    x = _x_or_sample(x, num_points, 2, -2.0, 2.0, seed)
    x1, x2 = x.T
    hi = 4 * x1**2 - 2.1 * x1**4 + x1**6 / 3 + x1 * x2 - 4 * x2**2 + 4 * x2**4
    lo = 2 * x1**2 - 2.1 * x1**4 + x1**6 / 3 + 0.5 * x1 * x2 - 4 * x2**2 + 2 * x2**4
    return x, [_col(lo), _col(hi)]


def test_function_d6(x=None, *, num_points=200, seed=0) -> TwoF:
    x = _x_or_sample(x, num_points, 2, 0.0, 1.0, seed)
    x1, x2 = x.T
    hi = ((30 + 5 * x1 * np.sin(5 * x1)) * (4 + np.exp(-5 * x2)) - 100) / 6
    lo = ((30 + 5 * x1 * np.sin(5 * x1)) * (4 + 0.4 * np.exp(-5 * x2)) - 100) / 6
    return x, [_col(lo), _col(hi)]


def test_function_d7(x=None, *, num_points=200, seed=0) -> TwoF:
    x = _x_or_sample(x, num_points, 2, -3.0, 4.0, seed)
    hi = np.sum(x**4 - 16 * x**2 + 5 * x, axis=1)
    lo = np.sum(x**4 - 16 * x**2, axis=1)
    return x, [_col(lo), _col(hi)]


def test_function_d8(x=None, *, num_points=200, seed=0) -> TwoF:
    x = _x_or_sample(x, num_points, 2, 0.0, 1.0, seed)
    x1, x2 = x.T
    a = (1 - 2 * x1 + 0.05 * np.sin(4 * np.pi * x2 - x1)) ** 2
    b = (x2 - 0.5 * np.sin(2 * np.pi * x1)) ** 2
    return x, [_col(a + 4 * b), _col(a + b)]


def test_function_d9(x=None, *, num_points=200, seed=0) -> TwoF:
    x = _x_or_sample(x, num_points, 3, 0.0, 1.0, seed)
    x1, x2, x3 = x.T
    hi = (x1 - 1) ** 2 + (x1 - x2) ** 2 + x2 * x3 + 0.5
    lo = 0.2 * hi - 0.5 * x1 - 0.2 * x1 * x2 - 0.1
    return x, [_col(lo), _col(hi)]


def test_function_d10(x=None, *, num_points=200, seed=0) -> TwoF:
    x = _x_or_sample(x, num_points, 8, -3.0, 3.0, seed)
    hi = np.sum(x**4 - 16 * x**2 + 5 * x, axis=1)
    lo = np.sum(0.3 * x**4 - 16 * x**2 + 5 * x, axis=1)
    return x, [_col(lo), _col(hi)]


# --------------------------------------------------- test3..test9 functions
def multi_fidelity_test3_function(x=None, *, num_points=200, seed=0) -> TwoF:
    x = _x_or_sample(x, num_points, 1, 0.0, 1.0, seed)
    lo = np.exp(1.4 * x) * np.cos(3.5 * np.pi * x)
    xs = np.where(np.abs(x) < 1e-6, 1e-6, x)
    hi = np.exp(x) * np.cos(x) + 1.0 / xs**2
    return x, [lo, hi]


def multi_fidelity_test4_function(x=None, *, num_points=200, seed=0) -> TwoF:
    x = _x_or_sample(x, num_points, 1, 0.0, 10.0, seed)
    lo = np.sin(2 * np.pi * x / 10) + 0.2 * np.sin(2 * np.pi * x / 2.5)
    hi = np.sin(2 * np.pi * x / 2.5) + np.cos(2 * np.pi * x / 2.5)
    return x, [lo, hi]


def multi_fidelity_test5_function(x=None, *, num_points=200, seed=0) -> TwoF:
    x = _x_or_sample(x, num_points, 2, -2.0, 2.0, seed)

    def hi_fn(z):
        x1, x2 = z.T
        return 4 * x1**2 - 2.1 * x1**4 + x1**6 / 3 - 4 * x2**2 + 4 * x2**4 + x1 * x2

    x1, x2 = x.T
    lo = hi_fn(0.7 * x) + x1 * x2 - 65
    return x, [_col(lo), _col(hi_fn(x))]


def multi_fidelity_test6_function(x=None, *, num_points=200, seed=0) -> TwoF:
    x = _x_or_sample(x, num_points, 6, 0.0, 1.0, seed)
    x1, x2, x3, x4, x5, x6 = x.T
    lo = 100 * np.exp(np.sin(x1)) + 5 * x2 * x3 + x4 + np.exp(x5 * x6)
    hi = np.exp(np.sin((0.9 * x1 + 0.9 * 0.48) ** 10)) + x2 * x3 + x4
    return x, [_col(lo), _col(hi)]


def multi_fidelity_test7_function(x=None, *, num_points=200, seed=0) -> TwoF:
    if x is None:
        rng = np.random.default_rng(seed)
        x = np.concatenate(
            [rng.random((num_points, 4)) * 2 * np.pi, rng.random((num_points, 4))],
            axis=1,
        )
    x = np.atleast_2d(np.asarray(x, float))
    s4 = np.sum(x[:, :4], axis=1)
    rc = np.sum(x[:, 4:], axis=1) * np.cos(s4)
    rs = np.sum(x[:, 4:], axis=1) * np.sin(s4)
    lo = rc + rs
    hi = np.sqrt(rc**2 + rs**2)
    return x, [_col(lo), _col(hi)]


def multi_fidelity_test8_function(x=None, *, num_points=200, seed=0) -> TwoF:
    x = _x_or_sample(x, num_points, 20, -3.0, 3.0, seed)
    hi = x[:, 0] ** 2 + np.sum((2 * x[:, 1:] ** 2 - x[:, :-1]) ** 2, axis=1)
    lo = 0.8 * hi - np.sum(0.4 * x[:, :-1] * x[:, 1:], axis=1) - 50
    return x, [_col(lo), _col(hi)]


def multi_fidelity_test9_function(x=None, *, num_points=200, seed=0) -> TwoF:
    x = _x_or_sample(x, num_points, 30, -3.0, 2.0, seed)
    i = np.arange(1, 30)
    hi = (
        (x[:, 0] - 1) ** 2
        + (x[:, -1] - 1) ** 2
        + 30 * np.sum((30 - i)[None, :] * (x[:, :-1] ** 2 - x[:, 1:]) ** 2, axis=1)
    )
    lo = hi**3 + hi**2 + hi
    return x, [_col(lo), _col(hi)]


# ----------------------------------------------------------------- registry
# name -> (fn, x_dim, n_fidelities)
ZOO: Dict[str, Tuple[Callable, int, int]] = {
    "forrester": (multi_fidelity_forrester_my, 1, 4),
    "non_linear_sin": (multi_fidelity_non_linear_sin, 1, 2),
    "colville": (multi_fidelity_Colville, 4, 2),
    "toal": (multi_fidelity_Toal, 10, 2),
    "p1": (multi_fidelity_p1_simp, 1, 3),
    "p2": (multi_fidelity_p2_simp, 1, 3),
    "p3": (multi_fidelity_p3_simp, 2, 3),
    "p4": (multi_fidelity_p4_simp, 2, 3),
    "p5": (multi_fidelity_p5_simp, 2, 3),
    "maolin1": (multi_fidelity_maolin1, 1, 2),
    "maolin5": (multi_fidelity_maolin5, 2, 2),
    "maolin6": (multi_fidelity_maolin6, 2, 2),
    "maolin7": (multi_fidelity_maolin7, 2, 2),
    "maolin8": (multi_fidelity_maolin8, 2, 2),
    "maolin10": (multi_fidelity_maolin10, 2, 2),
    "maolin12": (multi_fidelity_maolin12, 2, 2),
    "maolin13": (multi_fidelity_maolin13, 2, 2),
    "maolin15": (multi_fidelity_maolin15, 3, 2),
    "maolin19": (multi_fidelity_maolin19, 6, 2),
    "maolin20": (multi_fidelity_maolin20, 8, 2),
    "shuo6": (multi_fidelity_shuo6, 2, 2),
    "shuo11": (multi_fidelity_shuo11, 3, 2),
    "shuo15": (multi_fidelity_shuo15, 8, 2),
    "shuo16": (multi_fidelity_shuo16, 10, 2),
    "tl1": (test_function_d1, 1, 2),
    "tl2": (test_function_d2, 1, 2),
    "tl3": (test_function_d3, 1, 2),
    "tl4": (test_function_d4, 1, 2),
    "tl5": (test_function_d5, 2, 2),
    "tl6": (test_function_d6, 2, 2),
    "tl7": (test_function_d7, 2, 2),
    "tl8": (test_function_d8, 2, 2),
    "tl9": (test_function_d9, 3, 2),
    "tl10": (test_function_d10, 8, 2),
    "test3": (multi_fidelity_test3_function, 1, 2),
    "test4": (multi_fidelity_test4_function, 1, 2),
    "test5": (multi_fidelity_test5_function, 2, 2),
    "test6": (multi_fidelity_test6_function, 6, 2),
    "test7": (multi_fidelity_test7_function, 8, 2),
    "test8": (multi_fidelity_test8_function, 20, 2),
    "test9": (multi_fidelity_test9_function, 30, 2),
}
