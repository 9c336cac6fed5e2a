"""Exact GP and AR cascade (Kennedy-O'Hagan) of CIGP stages with the SE
kernel, in any dtype (float64 for the reference, float32 for the fit
check's float32 witness).

SE kernel: ``k(x, x') = exp(u)^2 exp(-0.5 |x - x'|^2 / exp(t)^2)``; noise
``max(exp(-b), 1e-4 k(x, x))``; ``Sigma = K + (noise + 1e-6) I``; NLML
``0.5 y^T Sigma^-1 y + sum log diag chol(Sigma) + 0.5 n log 2 pi`` per
column.  Squared distances by the quadratic expansion.

Parameters are dicts of tensors with an optional leading restart axis:
``{"t", "u", "b"}`` for a GP and ``"rho"`` beside them for a residual stage.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

LOG2PI = math.log(2.0 * math.pi)
JITTER = 1e-6
MIN_NOISE = 1e-4
NORM_EPS = 1e-10
LADDER = (1.0, 0.5, 0.25, 0.125, 0.0625, 2.0, 4.0)
B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8


# ------------------------------------------------------------------ data
class Norm:
    """Per-fidelity mean/std normalization (std with ddof 1; y over all
    elements, x per column), fitted on the fidelity's data."""

    def __init__(self, x, y):
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        self.x_mean, self.x_std = x.mean(0), x.std(0, ddof=1)
        self.y_mean, self.y_std = float(y.mean()), float(y.std(ddof=1))

    def x(self, x):
        return (np.asarray(x, np.float64) - self.x_mean) / (self.x_std + NORM_EPS)

    def y(self, y):
        return (np.asarray(y, np.float64) - self.y_mean) / (self.y_std + NORM_EPS)


def pair_rows(x1, x2):
    """(i1, i2): each row of x2 found in x1, with its first match in x1."""
    first = {}
    for i, row in enumerate(np.asarray(x1, np.float64)):
        first.setdefault(row.tobytes(), i)
    pairs = [(first[r.tobytes()], j) for j, r in enumerate(np.asarray(x2, np.float64))
             if r.tobytes() in first]
    if not pairs:
        return np.zeros(0, int), np.zeros(0, int)
    a, b = zip(*pairs)
    return np.asarray(a), np.asarray(b)


def residual_norm(res: np.ndarray) -> tuple:
    """(shift, scale) of residual targets: mean and population std, identity
    where the std is not finite or under 1e-8."""
    shift, scale = float(np.mean(res)), float(np.std(res))
    if not np.isfinite(scale) or scale < 1e-8:
        return 0.0, 1.0
    return shift, scale


def median_heuristic(x: np.ndarray, max_rows: int = 256) -> np.ndarray:
    """Per-dimension median of |x_i - x_j| over at most ``max_rows`` evenly
    spaced rows (indices from a float32 linspace, truncated), floored at
    1e-3; an even count's median is the mean of the two middle values."""
    x = np.asarray(x, np.float32)
    n = x.shape[0]
    if n > max_rows:
        step = np.arange(max_rows, dtype=np.float32) / np.float32(max_rows - 1)
        idx = (np.float32(0) * (1 - step) + np.float32(n - 1) * step).astype(np.int32)
        x = x[idx]
    diffs = np.abs(x[:, None, :] - x[None, :, :]).reshape(-1, x.shape[1])
    s = np.sort(diffs, axis=0)
    m = s.shape[0]
    return np.maximum((s[(m - 1) // 2] + s[m // 2]) / 2, 1e-3).astype(np.float64)


# ------------------------------------------------------------------ GP
def sq_dist(x1, x2):
    n1 = (x1 * x1).sum(-1)[..., :, None]
    n2 = (x2 * x2).sum(-1)[..., None, :]
    return torch.clamp(n1 + n2 - 2.0 * (x1 @ x2.transpose(-1, -2)), min=0.0)


def _b(a, nd):
    """A (*batch) parameter shaped to broadcast against (*batch, n, m)."""
    return a.reshape(a.shape + (1,) * nd)


def gram(p, x1, x2):
    sv = torch.exp(p["u"]) ** 2
    ls2 = torch.exp(p["t"]) ** 2
    return _b(sv, 2) * torch.exp(-0.5 * sq_dist(x1, x2) / _b(ls2, 2))


def noise(p):
    sv = torch.exp(p["u"]) ** 2
    return torch.maximum(torch.exp(-p["b"]), MIN_NOISE * sv)


def sigma(p, x):
    K = gram(p, x, x)
    return K + torch.diag_embed(_b(noise(p) + JITTER, 1).expand(K.shape[:-1]))


def nll(p, x, y, held_in=None):
    """NLML per restart; ``y`` (n, c) or (*batch, n, c).  With ``held_in``
    (a dtype), Sigma and y are first rounded to it and the rest runs in
    Sigma's own dtype: what holding the inputs in that dtype alone costs."""
    S = sigma(p, x)
    if held_in is not None:
        S, y = S.to(held_in).to(S.dtype), y.to(held_in).to(S.dtype)
    L = torch.linalg.cholesky(S)
    a = torch.linalg.solve_triangular(L, y.expand(S.shape[:-2] + y.shape[-2:]), upper=False)
    n, c = y.shape[-2], y.shape[-1]
    return (0.5 * (a * a).sum((-2, -1)) + c * torch.log(L.diagonal(dim1=-2, dim2=-1)).sum(-1)
            + 0.5 * n * c * LOG2PI)


def predict_diag(p, x, y, xt):
    """Posterior mean (m, c) and diagonal variance (m,) plus the noise."""
    S = sigma(p, x)
    L = torch.linalg.cholesky(S)
    Ks = gram(p, x, xt)
    v = torch.linalg.solve_triangular(L, Ks, upper=False)
    a = torch.cholesky_solve(y, L)
    mean = Ks.transpose(-1, -2) @ a
    var = torch.clamp(torch.exp(p["u"]) ** 2 - (v * v).sum(-2), min=0.0) + noise(p)
    return mean, var


# ------------------------------------------------------------------ training
def stage_loss(p, x, y, yl=None, shift=0.0, scale=1.0, held_in=None):
    """A stage's NLML: fidelity 0's GP, or the residual GP of
    ``(y - rho yl - shift) / scale``; ``held_in`` as for `nll`."""
    if yl is None:
        return nll(p, x, y, held_in=held_in)
    rho = _b(p["rho"], 2)
    return nll(p, x, (y - rho * yl - shift) / scale, held_in)


def restart_batch(p0: Dict[str, float], x_norm: np.ndarray, restarts: int, dtype, device):
    """The restart ladder: restart 0 is ``p0``; restart i >= 1 takes the
    length scale log(mean(LADDER[i-1] * median heuristic)) and b = 2."""
    med = median_heuristic(x_norm)
    rows = [dict(p0)]
    for i in range(1, restarts):
        q = dict(p0)
        q["t"] = float(np.log(np.float32(np.mean(np.float32(med * LADDER[i - 1])))))
        q["b"] = 2.0
        rows.append(q)
    return {k: torch.tensor([r[k] for r in rows], dtype=dtype, device=device) for k in p0}


def adam(loss_fn, p, steps: int, lr: float):
    """``steps`` Adam steps on every restart (the loss summed), with the
    last-good rollback of a non-finite step.  Returns the losses
    (R, steps) and the params whose loss was last finite."""
    keys = list(p)
    p = {k: v.detach().clone() for k, v in p.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    s = {k: torch.zeros_like(v) for k, v in p.items()}
    count = None
    good, hist = dict(p), []
    for _ in range(steps):
        q = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        with torch.enable_grad():
            loss = loss_fn(q)
            grads = torch.autograd.grad(loss.sum(), [q[k] for k in keys])
        loss = loss.detach()
        hist.append(loss)
        if count is None:
            count = torch.zeros_like(loss)
        c = count + 1
        ok = torch.isfinite(loss)
        new_p, new_m, new_s = {}, {}, {}
        for k, g in zip(keys, grads):
            bc = _b(c, g.ndim - c.ndim)
            mk = (1 - B1) * g + B1 * m[k]
            sk = (1 - B2) * g * g + B2 * s[k]
            upd = -lr * (mk / (1 - B1 ** bc)) / (torch.sqrt(sk / (1 - B2 ** bc)) + ADAM_EPS)
            ok = ok & torch.isfinite(upd).reshape(ok.shape + (-1,)).all(-1)
            new_p[k], new_m[k], new_s[k] = p[k] + upd, mk, sk

        def sel(a, b):
            return torch.where(_b(ok, a.ndim - ok.ndim), a, b)

        good = {k: sel(p[k], good[k]) for k in keys}
        p = {k: sel(new_p[k], good[k]) for k in keys}
        m = {k: sel(new_m[k], m[k]) for k in keys}
        s = {k: sel(new_s[k], s[k]) for k in keys}
        count = torch.where(ok, c, count)
    return torch.stack(hist, -1), good


# ------------------------------------------------------------------ the AR cascade
class ARData:
    """The cascade's stage datasets in float64 numpy from raw per-fidelity
    (x, y): the normalizers, each stage's normalized inputs, and its
    targets before rho (``y``; ``yl`` for residual stages),
    ``shift``/``scale`` from rho = 1."""

    def __init__(self, xs: Sequence[np.ndarray], ys: Sequence[np.ndarray]):
        self.xs = [np.asarray(x, np.float64) for x in xs]
        self.ys = [np.asarray(y, np.float64).reshape(len(x), -1) for x, y in zip(xs, ys)]
        self.norms = [Norm(x, y) for x, y in zip(self.xs, self.ys)]

    def stage0(self):
        nm = self.norms[0]
        return nm.x(self.xs[0]), nm.y(self.ys[0])

    def subset_stage(self, i: int):
        """(x, yl, yh, shift, scale) of residual stage i over the rows of
        fidelity i also observed at fidelity i-1."""
        i1, i2 = pair_rows(self.xs[i - 1], self.xs[i])
        n1, n2 = self.norms[i - 1], self.norms[i]
        yl = n1.y(self.ys[i - 1][i1])
        x, yh = n2.x(self.xs[i][i2]), n2.y(self.ys[i][i2])
        shift, scale = residual_norm(yh - yl)
        return x, yl, yh, shift, scale


def to_t(a, dtype, device):
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def ar_posterior(data: ARData, stage_params: List[Dict[str, float]], x_test,
                 dtype=torch.float64, device="cpu"):
    """The cascade's posterior mean and diagonal variance at raw ``x_test``
    (raw y units) from each stage's parameters (``t, u, b`` and, for stages
    i >= 1, ``rho``).  Residual targets are worked out again from the data:
    each stage's paired rows with fidelity i-1."""
    level = len(stage_params) - 1
    P = [{k: torch.tensor(float(v), dtype=dtype, device=device) for k, v in sp.items()}
         for sp in stage_params]
    T = lambda a: to_t(a, dtype, device)  # noqa: E731
    mean = var = None
    for i in range(level + 1):
        if i == 0:
            x, y = data.stage0()
            rho, shift, scale = 1.0, 0.0, 1.0
        else:
            rho = float(stage_params[i]["rho"])
            x, yl, yh, shift, scale = data.subset_stage(i)
            y = (yh - rho * yl - shift) / scale
        m, v = predict_diag(P[i], T(x), T(y), T(data.norms[i].x(x_test)))
        if i == 0:
            mean, var = m[:, 0], v
        else:
            mean = rho * mean + shift + scale * m[:, 0]
            var = rho ** 2 * var + scale ** 2 * v
    nm = data.norms[level]
    return mean * nm.y_std + nm.y_mean, var * nm.y_std ** 2
