"""GAR, the generalized autoregression of Wang et al. ("GAR: Generalized
Autoregression for Multi-Fidelity Fusion", NeurIPS 2022; IceLab-X/
FidelityFusion `FidelityFusion_Models/GAR.py`), over HOGP stages with the
ARD kernel, in plain PyTorch and float64 with TF32 off.

HOGP (a stage).  Targets ``Y (n, d_1, .., d_M)``; one kernel shared by the
inputs and the output modes' integer grids ``0 .. d_m - 1``:
``k(a, b) = |sv| exp(-0.5 |a / l - b / l|^2)``, ``l = |ls| + 1e-9`` (one
length scale, as the program's HOGP holds it).  With ``K_0 = k(X, X) +
1e-6 I``, ``K_m = k(g_m, g_m)`` and noise ``s = 1 / nv``,

    vec(Y) ~ N(0, K_0 (x) K_1 (x) .. (x) K_M + s I),
    NLML = 0.5 (N log 2 pi + sum log A + sum T^2 / A) / N,   N = n d_1 .. d_M,

with ``K_m = V_m diag(w_m) V_m^T`` each by its exact ``torch.linalg.eigh``,
``A = w_0 (x) .. (x) w_M + s`` and ``T = Y x_0 V_0^T .. x_M V_M^T``.  The
gradient is autograd's (`hogp_nll` says through which form).  The posterior at ``x*``: mean
``(Sigma^-1 Y) x_0 k(x*, X) x_1 K_1 .. x_M K_M`` and, per element, ``|sv|^(M+1)
- sum (k(x*, X) V_0)^2 (x) .. (x) (K_M V_M)^2 / A + s``.

GAR.  Stage 0 is a HOGP of fidelity 0's normalized fields.  Stage i fits a
HOGP to ``(Y_i - L_i(Y_{i-1}) - shift) / scale`` over the rows observed at
both fidelities, ``L_i`` one trainable linear map per output mode (its
lift), initialized to linear interpolation between the grids, trained
through the NLML; ``shift`` and ``scale`` are the mean and population std
of that residual at the initial lift.  The cascade's mean is ``L_i(mean)
+ shift + scale m_i``, its variance ``L_i(var) + scale^2 v_i``.

Departures, each also the program's: the variance passes through the
lift's own maps (not their squares), as the cascade of the JAX package and
of the program does; the eigenvalues are clamped at 0 before the product;
the normalizers are FidelityFusion's (x per column, y over all elements,
std with ddof 1), the residual's std has ddof 0.  The reference has no
tracked spectrum: every ``eigh`` is exact, every step.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from portbench.reference import cigp
from portbench.reference.cigp import LADDER, Norm, median_heuristic, pair_rows, residual_norm

LOG2PI = math.log(2.0 * math.pi)
JITTER = 1e-6
LS_EPS = 1e-9
LADDER_NV = 0.3  # the ladder restarts' noise_variance


@contextlib.contextmanager
def no_tf32():
    """Full-precision products (TF32 off for matmul and cuDNN) inside."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ------------------------------------------------------------------ tensor algebra
def mode_dot(t, m, k: int):
    """``t`` ``(R, ...)`` times ``m`` ``(R, J, I)`` along ``t``'s axis ``k``
    (of size I)."""
    tm = torch.movedim(t, k, -1)
    mb = m.reshape(m.shape[:1] + (1,) * (tm.ndim - 3) + m.shape[1:])
    return torch.movedim(tm @ mb.transpose(-1, -2), -1, k)


def outer(vectors):
    """``out[r, i_0, .., i_M] = prod_m vectors[m][r, i_m]``."""
    out = vectors[0]
    for v in vectors[1:]:
        out = out[..., None] * v.reshape(v.shape[:1] + (1,) * (out.ndim - 1) + v.shape[1:])
    return out


def lift(maps, y):
    """``y`` ``(R, n, l_1, .., l_M)`` onto the grid ``(R, n, h_1, .., h_M)``
    by the per-mode maps ``(R, l_m, h_m)``."""
    for k, M in enumerate(maps):
        y = mode_dot(y, M.transpose(-1, -2), k + 2)
    return y


def interp_identity(l_dim: int, h_dim: int) -> np.ndarray:
    """The lift's initial map ``(l_dim, h_dim)``: linear interpolation of a
    length-l_dim signal onto h_dim evenly spaced points (the identity where
    they match), in float32 as the program initializes it."""
    if l_dim == h_dim:
        return np.eye(l_dim, dtype=np.float32)
    pos = np.linspace(0, l_dim - 1, h_dim)
    lo = np.floor(pos).astype(int)
    hi = np.minimum(lo + 1, l_dim - 1)
    w = (pos - lo).astype(np.float32)
    M = np.zeros((l_dim, h_dim), dtype=np.float32)
    M[lo, np.arange(h_dim)] += 1.0 - w
    M[hi, np.arange(h_dim)] += w
    return M


# ------------------------------------------------------------------ HOGP
def ard_gram(p, a, b):
    """``(R, n_a, n_b)`` Grams of the restarts' parameters ``p["ls"]``,
    ``p["sv"]`` ``(R,)`` at shared inputs ``a (n_a, d)``, ``b (n_b, d)``, by
    direct differences."""
    inv = 1.0 / (torch.abs(p["ls"]) + LS_EPS)
    diff = a[:, None, :] - b[None, :, :]
    d2 = (diff * diff).sum(-1)
    scaled = d2[None] * (inv * inv)[:, None, None]
    return torch.abs(p["sv"])[:, None, None] * torch.exp(-0.5 * scaled)


def grids(shape, like):
    return [torch.arange(d, dtype=like.dtype, device=like.device)[:, None] for d in shape]


def _grams(p, x, shape):
    """K_0 (with its jitter) and each output mode's Gram."""
    K0 = ard_gram(p, x, x)
    eye = torch.eye(K0.shape[-1], dtype=x.dtype, device=x.device)
    return [K0 + JITTER * eye] + [ard_gram(p, g, g) for g in grids(shape, x)]


def _spectra(p, x, shape):
    """The Grams and their exact eigenpairs, the values clamped at 0."""
    Ks = _grams(p, x, shape)
    pairs = [torch.linalg.eigh(K) for K in Ks]
    return Ks, [torch.clamp(w, min=0.0) for w, _ in pairs], [V for _, V in pairs]


def hogp_nll(p, x, y):
    """The per-element NLML of each restart, ``(R,)``; ``y`` ``(R, n,
    *shape)`` (or ``(1, n, *shape)``, shared by the restarts).

    Its gradient is autograd's through a form that never differentiates an
    eigenvector: each eigenvalue is the Rayleigh quotient ``v^T K v`` of
    its eigenvector held fixed (the first-order change of an eigenvalue),
    and the quadratic form is ``2 <a, y> - <a, Sigma a>`` at ``a = Sigma^-1
    y`` held fixed (its value and gradient are those of ``y^T Sigma^-1 y``,
    ``Sigma a`` by mode products with the Grams).  Autograd through
    ``eigh`` itself divides by eigenvalue gaps, and is NaN where K_0's
    eigenvalues coincide, as they do at small length scales."""
    R, shape = p["ls"].shape[0], tuple(y.shape[2:])
    Ks = _grams(p, x, shape)
    with torch.no_grad():
        Vs = [torch.linalg.eigh(K)[1] for K in Ks]
    lams = [torch.clamp((V * (K @ V)).sum(-2), min=0.0) for K, V in zip(Ks, Vs)]
    noise = (1.0 / p["nv"]).reshape((R,) + (1,) * (len(shape) + 1))
    A = outer(lams) + noise
    y = y.expand((R,) + y.shape[1:])
    with torch.no_grad():
        a = y
        for k, V in enumerate(Vs):
            a = mode_dot(a, V.transpose(-1, -2), k + 1)
        a = a / A
        for k, V in enumerate(Vs):
            a = mode_dot(a, V, k + 1)
    Sa = a
    for k, K in enumerate(Ks):
        Sa = mode_dot(Sa, K, k + 1)
    Sa = Sa + noise * a
    dims = tuple(range(1, y.ndim))
    N = float(math.prod(y.shape[1:]))
    quad = 2.0 * (a * y).sum(dims) - (a * Sa).sum(dims)
    return 0.5 * (N * LOG2PI + torch.log(A).sum(dims) + quad) / N


def hogp_posterior(p, x, y, xt):
    """Posterior mean and per-element variance ``(m, *shape)`` of one
    restart's parameters (``(1,)`` each) at ``xt (m, d)``."""
    shape = tuple(y.shape[1:])
    Ks, lams, Vs = _spectra(p, x, shape)
    noise = 1.0 / p["nv"]
    A = outer(lams) + noise.reshape((1,) * (len(shape) + 2))
    T = y[None]
    for k, V in enumerate(Vs):
        T = mode_dot(T, V.transpose(-1, -2), k + 1)
    G = T / A
    for k, V in enumerate(Vs):
        G = mode_dot(G, V, k + 1)
    Kx = ard_gram(p, xt, x)
    mean = mode_dot(G, Kx, 1)
    P = [(Kx @ Vs[0]) ** 2]
    for k in range(len(shape)):
        mean = mode_dot(mean, Ks[k + 1], k + 2)
        P.append((Ks[k + 1] @ Vs[k + 1]) ** 2)
    explained = 1.0 / A
    for k, Pk in enumerate(P):
        explained = mode_dot(explained, Pk, k + 1)
    prior = torch.abs(p["sv"]) ** (len(shape) + 1)
    var = torch.clamp(prior.reshape((1,) * (len(shape) + 2)) - explained, min=1e-12) + noise
    return mean[0], var[0]


# ------------------------------------------------------------------ GAR
class GARData:
    """The cascade's stage datasets in float64 numpy from raw per-fidelity
    inputs ``(n_i, d)`` and fields ``(n_i, *shape_i)``."""

    def __init__(self, xs: Sequence[np.ndarray], ys: Sequence[np.ndarray]):
        self.xs = [np.asarray(x, np.float64) for x in xs]
        self.ys = [np.asarray(y, np.float64) for y in ys]
        self.norms = [Norm(x, y) for x, y in zip(self.xs, self.ys)]
        self.shapes = [y.shape[1:] for y in self.ys]

    def stage0(self):
        nm = self.norms[0]
        return nm.x(self.xs[0]), nm.y(self.ys[0])

    def subset_stage(self, i: int):
        """(x, yl, yh, shift, scale) of residual stage i over the rows of
        fidelity i also observed at fidelity i-1; shift and scale at the
        initial lift."""
        i1, i2 = pair_rows(self.xs[i - 1], self.xs[i])
        n1, n2 = self.norms[i - 1], self.norms[i]
        yl = n1.y(self.ys[i - 1][i1])
        x, yh = n2.x(self.xs[i][i2]), n2.y(self.ys[i][i2])
        maps = [torch.as_tensor(M, dtype=torch.float64)[None] for M in self.initial_maps(i)]
        res = yh[None] - lift(maps, torch.as_tensor(yl)[None]).numpy()
        shift, scale = residual_norm(res)
        return x, yl, yh, shift, scale

    def initial_maps(self, i: int) -> List[np.ndarray]:
        return [interp_identity(l, h) for l, h in zip(self.shapes[i - 1], self.shapes[i])]


def to_t(a, device):
    return cigp.to_t(a, torch.float64, device)


def maps_of(p) -> list:
    """A residual stage's lift maps, ``p["m0"], p["m1"], ..``."""
    return [p[f"m{k}"] for k in range(sum(1 for key in p if key.startswith("m")))]


def stage_loss(p, x, y, yl=None, shift=0.0, scale=1.0):
    """A stage's NLML ``(R,)``: fidelity 0's HOGP of ``y`` ``(n, *shape)``,
    or the HOGP of the residual of ``y`` over the lift of ``yl`` by the
    maps ``p["m0"], p["m1"], ..`` (``(R, l_m, h_m)`` each)."""
    if yl is None:
        return hogp_nll(p, x, y[None])
    return hogp_nll(p, x, (y[None] - lift(maps_of(p), yl[None]) - shift) / scale)


def restart_batch(p0: dict, x_norm: np.ndarray, restarts: int, device) -> Dict:
    """The restart ladder of ``p0`` (``ls``, ``sv``, ``nv`` floats and, for a
    residual stage, the maps ``m0, m1, ..`` as arrays): restart 0 is
    ``p0``; restart i >= 1 takes the length scale mean(LADDER[i-1] *
    median heuristic), in float32, and ``nv`` = 0.3."""
    med = median_heuristic(x_norm).astype(np.float32)
    rows = [dict(p0)]
    for i in range(1, restarts):
        q = dict(p0)
        q["ls"] = float(np.mean(med * np.float32(LADDER[i - 1]), dtype=np.float32))
        q["nv"] = LADDER_NV
        rows.append(q)
    return {k: (torch.tensor([r[k] for r in rows], dtype=torch.float64, device=device)
                if k in ("ls", "sv", "nv") else to_t(v, device)[None].repeat(restarts, 1, 1))
            for k, v in p0.items()}


def stage_params(sp: dict, device) -> dict:
    """One stage's trained parameters (floats and, for a residual stage,
    the maps ``m0, m1, ..`` as arrays) as ``(1, ...)`` tensors."""
    return {k: (torch.tensor([float(v)], dtype=torch.float64, device=device)
                if k in ("ls", "sv", "nv") else to_t(v, device)[None])
            for k, v in sp.items()}


def stage_args(data: GARData, i: int, device) -> dict:
    """`stage_loss`'s data arguments of stage i."""
    if i == 0:
        x, y = data.stage0()
        return dict(x=to_t(x, device), y=to_t(y, device))
    x, yl, yh, shift, scale = data.subset_stage(i)
    return dict(x=to_t(x, device), y=to_t(yh, device), yl=to_t(yl, device), shift=shift,
                scale=scale)


def gar_posterior(data: GARData, params: List[dict], x_test, device):
    """The cascade's posterior mean and per-element variance at raw
    ``x_test``, in raw units of the top fidelity, from each stage's
    trained parameters (`stage_params`' input)."""
    mean = var = None
    for i, sp in enumerate(params):
        p = stage_params(sp, device)
        a = stage_args(data, i, device)
        xt = to_t(data.norms[i].x(x_test), device)
        if i == 0:
            mean, var = hogp_posterior(p, a["x"], a["y"], xt)
            continue
        maps = maps_of(p)
        y = ((a["y"][None] - lift(maps, a["yl"][None]) - a["shift"]) / a["scale"])[0]
        m, v = hogp_posterior(p, a["x"], y, xt)
        mean = lift(maps, mean[None])[0] + a["shift"] + a["scale"] * m
        var = lift(maps, var[None])[0] + a["scale"] ** 2 * v
    nm = data.norms[-1]
    return mean * nm.y_std + nm.y_mean, var * nm.y_std ** 2
