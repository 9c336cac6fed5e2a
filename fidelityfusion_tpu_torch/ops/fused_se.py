"""Analytic-gradient SE NLML: the large-n single-matrix training path.

Port of `fidelityfusion_tpu/ops/fused_se.py`.  For the scalar SE kernel

    Sigma = e^{2u} exp(-d^2 e^{-2t} / 2) + c I,  c = max(e^{-b}, min_noise e^{2u}) + jitter
    G     = dNLL/dSigma = (D Sigma^{-1} - A A^T) / 2,   A = Sigma^{-1} Y

the three hyperparameter gradients need one GEMM beyond the factorization:

    dNLL/db = -e^{-b} tr(G)                      (tr Sigma^{-1} = ||W||_F^2)
    dNLL/du = 2 <G, K>                           (closed forms in tr, A, Y)
    dNLL/dt = <G, M>,  M = K . d^2 e^{-2t}       (tr(Sigma^{-1} M) = sum((W M) . W))

The forward builds Sigma with K1 (`ops/gram.py`) and factors it with K2 +
K3b (`ops/chol.py:chol_inv_padded`).  The x gradient is ZERO by design:
training never differentiates the NLML with respect to its inputs.
Parameters and losses may carry a leading batch dimension.
"""

from __future__ import annotations

import torch

from fidelityfusion_tpu_torch.ops.chol import chol_inv_padded
from fidelityfusion_tpu_torch.ops.gram import gram
from fidelityfusion_tpu_torch.ops.linalg import LOG2PI


def _se_sigma_parts(t, u, b, x, jitter, min_noise=0.0):
    """(K, c, Sigma) with the relative nugget floor: mean(diag K) = e^{2u}
    exactly for SE.  One K1 launch builds Sigma; K is Sigma less c on the
    diagonal."""
    sv = torch.exp(2.0 * u)
    c = torch.maximum(torch.exp(-b), min_noise * sv) + jitter
    inv_ls = torch.exp(-t)[..., None].expand(t.shape + (x.shape[-1],))
    Sigma = gram(x, x, inv_ls, sv, diag_add=c)
    K = Sigma.clone()
    K.diagonal(dim1=-2, dim2=-1).sub_(c[..., None])
    return K, c, Sigma


class _SeNlml(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, u, b, x, y, jitter, min_noise):
        n, d = y.shape[-2], y.shape[-1]
        K, c, Sigma = _se_sigma_parts(t, u, b, x, jitter, min_noise)
        L, W = chol_inv_padded(Sigma)
        gamma = W @ y
        val = (0.5 * (gamma * gamma).sum((-2, -1))
               + d * torch.log(L.diagonal(dim1=-2, dim2=-1)).sum(-1)
               + 0.5 * n * d * LOG2PI)
        ctx.save_for_backward(u, b, x, K, c, W, gamma, y)
        ctx.min_noise = min_noise
        return val

    @staticmethod
    def backward(ctx, g):
        u, b, x, K, c, W, gamma, y = ctx.saved_tensors
        n, d = y.shape[-2], y.shape[-1]
        A = W.transpose(-1, -2) @ gamma              # Sigma^{-1} Y
        tr_inv = (W * W).sum((-2, -1))               # tr(Sigma^{-1})
        a_sq = (A * A).sum((-2, -1))
        a_y = (A * y).sum((-2, -1))
        # d/db: zero while the nugget floor is active; the floor
        # min_noise e^{2u} then contributes to d/du instead
        floor = ctx.min_noise * torch.exp(2.0 * u)
        active = (torch.exp(-b) >= floor).to(W.dtype)
        tr_G = 0.5 * (d * tr_inv - a_sq)
        g_b = -active * torch.exp(-b) * tr_G
        # d/du: dK/du = 2K
        tr_SK = n - c * tr_inv
        aKa = a_y - c * a_sq
        g_u = (d * tr_SK - aKa) + (1.0 - active) * 2.0 * floor * tr_G
        # d/dt: M = K . d2 e^{-2t}, recovered from K itself
        # (d2 e^{-2t} = 2(2u - log K)); underflowed K gives M -> 0
        tiny = torch.finfo(K.dtype).tiny
        M = 2.0 * K * torch.clamp(
            2.0 * u[..., None, None] - torch.log(torch.clamp(K, min=tiny)), min=0.0)
        tr_SM = ((W @ M) * W).sum((-2, -1))          # the one extra GEMM
        aMa = (A * (M @ A)).sum((-2, -1))
        g_t = 0.5 * (d * tr_SM - aMa)
        g_x = torch.zeros_like(x) if ctx.needs_input_grad[3] else None
        gg = g[..., None, None]
        return g * g_t, g * g_u, g * g_b, g_x, gg * A, None, None


def se_nlml(params, x, y, jitter: float = 1e-6, min_noise: float = 0.0):
    """NLML of y ~ N(0, SE-Gram + noise I), columns summed: the value of
    `linalg.mvn_nll_fused` on the same Sigma, analytic gradients in
    ``params`` and ``y``, zero gradient in ``x``.

    ``params`` is the CIGP dict {"kernel": {"length_scale",
    "signal_variance"}, "log_beta"}; ``y`` is (*batch, n, d) or (n, d)."""
    t = params["kernel"]["length_scale"][..., 0]
    u = params["kernel"]["signal_variance"][..., 0]
    b = params["log_beta"][..., 0]
    y = y.expand(t.shape + y.shape[-2:])
    return _SeNlml.apply(t, u, b, x, y, float(jitter), float(min_noise))
