"""Dense Gaussian-process linear algebra: factorization, NLML, posterior.

Port of `fidelityfusion_tpu/ops/linalg.py`.  Every factorization goes
through the hand-written kernels (`ops/blocked.py:chol_inv_padded`, i.e.
K2/K3a + K3b on the card): each returns (L, W = inv(L)), and every solve
becomes a product with W, so no triangular solve remains anywhere.
Functions accept an optional leading batch dimension (the restart axis)
on ``Sigma (*batch, n, n)``, with ``y (*batch, n, d)`` or ``(n, d)``.

Conventions (as in the JAX package):
  * ``nll`` = 0.5 sum(gamma^2) + d sum(log diag L) + 0.5 n d log(2 pi),
    summed over the d output columns;
  * ``mask`` marks live rows; masked rows of Sigma are identity rows and
    their targets zero, which leaves the valid rows' likelihood and
    posterior exactly unchanged.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

JITTER = 1e-6
LOG2PI = math.log(2.0 * math.pi)


def _factor(Sigma):
    from fidelityfusion_tpu_torch.ops.blocked import chol_inv_padded

    return chol_inv_padded(Sigma)


def _diag(A):
    return A.diagonal(dim1=-2, dim2=-1)


def _mT(A):
    return A.transpose(-1, -2)


def assemble_sigma(K, noise, jitter: float = JITTER, y_var=None, mask=None,
                   relative_jitter: bool = False):
    """Sigma = K + (noise + jitter) I (+ diag(y_var)), masked rows -> identity.

    ``noise`` has K's batch shape (or is a scalar).  With ``relative_jitter``
    the jitter is ``jitter * mean(diag K)``.
    """
    n = K.shape[-1]
    noise = torch.as_tensor(noise, dtype=K.dtype, device=K.device)
    jit_val = jitter * _diag(K).mean(-1) if relative_jitter else jitter
    extra = (noise + jit_val)[..., None].expand(K.shape[:-1])
    if y_var is not None:
        extra = extra + y_var
    Sigma = K.clone()
    _diag(Sigma).add_(extra)
    if mask is None:
        return Sigma
    return apply_mask(Sigma, mask)


def apply_mask(Sigma, mask):
    """Zero the rows and columns of masked-out entries and put 1 on their
    diagonal (identity rows)."""
    m = mask.to(Sigma.dtype)
    eye = torch.eye(Sigma.shape[-1], dtype=Sigma.dtype, device=Sigma.device)
    return Sigma * (m[:, None] * m[None, :]) + eye * (1.0 - m)


def cholesky(Sigma):
    """Lower Cholesky factor (K2/K3a on the card)."""
    return _factor(Sigma)[0]


class _MvnNll(torch.autograd.Function):
    """NLML from the saved (W, gamma) with the closed-form backward

        dL/dSigma = 0.5 (d W^T W - alpha alpha^T),  dL/dy = alpha = W^T gamma.

    Shared by `mvn_nll_fused`, `ops/blocked.py:mvn_nll_hybrid` and
    `mvn_nll_blocked`: on the card they all factor through the kernels,
    so they differ only in how they pad."""

    @staticmethod
    def forward(ctx, Sigma, y):
        L, W = _factor(Sigma)
        gamma = W @ y
        n, d = y.shape[-2], y.shape[-1]
        val = (0.5 * (gamma * gamma).sum((-2, -1))
               + d * torch.log(_diag(L)).sum(-1) + 0.5 * n * d * LOG2PI)
        ctx.save_for_backward(W, gamma)
        return val

    @staticmethod
    def backward(ctx, g):
        W, gamma = ctx.saved_tensors
        d = gamma.shape[-1]
        alpha = _mT(W) @ gamma
        gg = g[..., None, None]
        dSigma = gg * 0.5 * (d * (_mT(W) @ W) - alpha @ _mT(alpha))
        return dSigma, gg * alpha


def mvn_nll_fused(Sigma, y):
    """NLML of y ~ N(0, Sigma) with the hand-written VJP (value and
    gradient match autodiff of `mvn_nll`); ``y`` is broadcast to Sigma's
    batch."""
    return _MvnNll.apply(Sigma, y.expand(Sigma.shape[:-2] + y.shape[-2:]))


def mvn_nll(Sigma, y, mask=None, method: str = "cholesky"):
    """NLML, columns summed.  ``mask`` zeroes masked targets and counts only
    live rows in the 2 pi constant.  ``method="direct"`` is the reference's
    numerical cross-check (LU solve and slogdet; not on any training
    path)."""
    if y.ndim == 1:
        y = y[:, None]
    d = y.shape[-1]
    n = y.shape[-2]
    correction = 0.0
    if mask is not None:
        y = y * mask[:, None].to(y.dtype)
        correction = 0.5 * (n - mask.sum().to(y.dtype)) * d * LOG2PI
    if method == "direct":
        _, logdet = torch.linalg.slogdet(Sigma)
        quad = 0.5 * (y * torch.linalg.solve(Sigma, y)).sum((-2, -1))
        return quad + 0.5 * d * logdet + 0.5 * n * d * LOG2PI - correction
    return mvn_nll_fused(Sigma, y) - correction


def posterior(Sigma, y, K_s, K_ss, mask=None):
    """Exact posterior mean and full covariance at test points:
    mu = K_s^T Sigma^{-1} y, cov = K_ss - v^T v with v = W K_s."""
    if mask is not None:
        m = mask.to(K_s.dtype)
        K_s = K_s * m[:, None]
        y = y * m[:, None]
    _, W = _factor(Sigma)
    alpha = _mT(W) @ (W @ y)
    v = W @ K_s
    return _mT(K_s) @ alpha, K_ss - _mT(v) @ v


def posterior_diag(Sigma, y, K_s, k_ss_diag, mask=None):
    """Posterior mean and diagonal variance only (O(n^2 m))."""
    if mask is not None:
        m = mask.to(K_s.dtype)
        K_s = K_s * m[:, None]
        y = y * m[:, None]
    _, W = _factor(Sigma)
    alpha = _mT(W) @ (W @ y)
    v = W @ K_s
    var = torch.clamp(k_ss_diag - (v * v).sum(-2), min=0.0)
    return _mT(K_s) @ alpha, var


def posterior_cache(Sigma, y, mask=None) -> dict:
    """Per-dataset factorization for repeated prediction:
    ``{"W": inv(L), "alpha": Sigma^{-1} y, "logdiagL": log diag L}``."""
    if mask is not None:
        y = y * mask[:, None].to(y.dtype)
    L, W = _factor(Sigma)
    alpha = _mT(W) @ (W @ y)
    return {"W": W, "alpha": alpha, "logdiagL": torch.log(_diag(L))}


def posterior_diag_cached(cache, K_s, k_ss_diag, mask=None):
    """`posterior_diag` from a `posterior_cache`: GEMMs only."""
    if mask is not None:
        K_s = K_s * mask[:, None].to(K_s.dtype)
    v = cache["W"] @ K_s
    var = torch.clamp(k_ss_diag - (v * v).sum(-2), min=0.0)
    return _mT(K_s) @ cache["alpha"], var


def posterior_cached(cache, K_s, K_ss, mask=None):
    """`posterior` (full covariance) from a `posterior_cache`."""
    if mask is not None:
        K_s = K_s * mask[:, None].to(K_s.dtype)
    v = cache["W"] @ K_s
    return _mT(K_s) @ cache["alpha"], K_ss - _mT(v) @ v


def chol_logdet(Sigma):
    """log|Sigma| from the factor."""
    return 2.0 * torch.log(_diag(cholesky(Sigma))).sum(-1)


def pad_rows(a, n_padded: int):
    """Zero-pad the leading axis of ``a`` to ``n_padded``."""
    pad = a.new_zeros((n_padded - a.shape[0],) + tuple(a.shape[1:]))
    return torch.cat([a, pad], dim=0)


def row_mask(n_valid: int, n_padded: int, device="cpu"):
    """Boolean mask, True on the first ``n_valid`` of ``n_padded`` rows."""
    return torch.arange(n_padded, device=device) < n_valid
