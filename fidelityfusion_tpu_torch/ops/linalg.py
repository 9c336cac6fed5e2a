"""Dense Gaussian-process linear algebra: factorization, NLML, posterior.

Port of `fidelityfusion_tpu/ops/linalg.py`.  Every factorization goes
through the hand-written kernels (`ops/chol.py:chol_inv_padded`, i.e.
K2/K3a + K3b on the card): each returns (L, W = inv(L)), and every solve
becomes a product with W, so no triangular solve remains anywhere.  The
NLML's Sigma gradient is K4 (`sigma_grad`, `csrc/nll_grad.cu`).
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

from fidelityfusion_tpu_torch.ops import cuda
from fidelityfusion_tpu_torch.ops.chol import chol_inv_padded

JITTER = 1e-6
LOG2PI = math.log(2.0 * math.pi)

# K4 (`csrc/nll_grad.cu`) forms the NLML's Sigma gradient from this many
# rows on: its measured crossover with the plain expression.  By device
# time on an H100 80GB HBM3 at 700 W, 4 restarts: K4 0.0217 ms against the
# plain expression's 0.0184 at n = 256, 0.0260 against 0.0257 at 320,
# 0.0399 against 0.0458 at 512; so below it the library GEMM stays.
NLL_GRAD_MIN_N = 320
_NLL_GRAD = cuda.Library("nll_grad.cu", {"ff_nll_grad": [
    cuda.PTR, cuda.I64, cuda.INT, cuda.PTR, cuda.INT, cuda.PTR, cuda.INT, cuda.PTR, cuda.PTR,
    cuda.INT, cuda.INT, cuda.PTR]})
NLL_GRAD_LAUNCHES = cuda.counter("nll_grad")  # K4


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
    return chol_inv_padded(Sigma)[0]


def sigma_grad_plain(W, alpha, g):
    """dNLL/dSigma = g/2 (d W^T W - alpha alpha^T) as one expression: K4's
    plain version, and the path below `NLL_GRAD_MIN_N` rows and in float64."""
    d = alpha.shape[-1]
    return g[..., None, None] * 0.5 * (d * (_mT(W) @ W) - alpha @ _mT(alpha))


def sigma_grad(W, alpha, g):
    """dNLL/dSigma = g/2 (d W^T W - alpha alpha^T) from W = inv(L)
    ``(*batch, n, n)``, lower-triangular (its entries above the diagonal
    are never read), alpha = Sigma^{-1} y ``(*batch, n, d)`` and the
    NLML's incoming gradient g ``(*batch)``: K4 on CUDA tensors (float32;
    W may be a cropped view of a padded inverse, its rows 16-byte
    aligned), `sigma_grad_plain` on CPU tensors."""
    if not W.is_cuda:
        return sigma_grad_plain(W, alpha, g)
    n, d = W.shape[-1], alpha.shape[-1]
    W3 = W.reshape((-1, n, n))
    B = W3.shape[0]
    a3 = alpha.reshape((B, n, d)).contiguous()
    g1 = g.reshape(-1)
    if g1.shape[0] != B:
        raise ValueError(f"sigma_grad: g has {g1.shape[0]} entries for {B} matrices")
    cuda.require_cuda("sigma_grad", a3)
    for t in (W3, g1):
        if t.device != a3.device or t.dtype != torch.float32:
            raise ValueError("sigma_grad: expected float32 tensors on one CUDA device")
    if (W3.stride(-1) != 1 or W3.stride(-2) % 4 or (B > 1 and W3.stride(0) % 4)
            or W3.data_ptr() % 16):
        raise ValueError("sigma_grad: W's rows must be contiguous and 16-byte aligned")
    out = torch.empty((B, n, n), dtype=W.dtype, device=W.device)
    if B and n:
        counter = torch.empty(1, dtype=torch.int32, device=W.device)  # K4's work counter
        _NLL_GRAD.call("ff_nll_grad", W3.data_ptr(), W3.stride(0), W3.stride(1), a3.data_ptr(),
                       d, g1.data_ptr(), g1.stride(0), out.data_ptr(), counter.data_ptr(), B, n,
                       cuda.stream_ptr(W.device))
        NLL_GRAD_LAUNCHES.launches += 1
    return out.reshape(W.shape)


class _MvnNll(torch.autograd.Function):
    """NLML from the saved (W, gamma) with the closed-form backward

        dL/dSigma = 0.5 (d W^T W - alpha alpha^T),  dL/dy = alpha = W^T gamma.

    Behind `mvn_nll` and `mvn_nll_fused`, for one matrix or a restart
    batch.  dL/dSigma is K4's (`sigma_grad`) in float32 from
    `NLL_GRAD_MIN_N` rows on."""

    @staticmethod
    def forward(ctx, Sigma, y):
        L, W = chol_inv_padded(Sigma)
        gamma = W @ y
        n, d = y.shape[-2], y.shape[-1]
        val = (0.5 * (gamma * gamma).sum((-2, -1))
               + d * torch.log(_diag(L)).sum(-1) + 0.5 * n * d * LOG2PI)
        ctx.save_for_backward(W, gamma)
        return val

    @staticmethod
    def backward(ctx, g):
        W, gamma = ctx.saved_tensors
        alpha = _mT(W) @ gamma
        k4 = W.dtype == torch.float32 and W.shape[-1] >= NLL_GRAD_MIN_N
        dSigma = (sigma_grad if k4 else sigma_grad_plain)(W, alpha, g)
        return dSigma, g[..., None, None] * alpha


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
    if mask is None and method != "direct":
        return mvn_nll_fused(Sigma, y)
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
    _, W = chol_inv_padded(Sigma)
    alpha = _mT(W) @ (W @ y)
    v = W @ K_s
    return _mT(K_s) @ alpha, K_ss - _mT(v) @ v


def posterior_diag(Sigma, y, K_s, k_ss_diag, mask=None):
    """Posterior mean and diagonal variance only (O(n^2 m))."""
    if mask is not None:
        m = mask.to(K_s.dtype)
        K_s = K_s * m[:, None]
        y = y * m[:, None]
    _, W = chol_inv_padded(Sigma)
    alpha = _mT(W) @ (W @ y)
    v = W @ K_s
    var = torch.clamp(k_ss_diag - (v * v).sum(-2), min=0.0)
    return _mT(K_s) @ alpha, var


def posterior_cache(Sigma, y, mask=None) -> dict:
    """Per-dataset factorization for repeated prediction:
    ``{"W": inv(L), "alpha": Sigma^{-1} y, "logdiagL": log diag L}``."""
    if mask is not None:
        y = y * mask[:, None].to(y.dtype)
    L, W = chol_inv_padded(Sigma)
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
