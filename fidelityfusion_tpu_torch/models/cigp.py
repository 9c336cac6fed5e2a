"""CIGP and GPBasic: exact GPs over one kernel.

Port of `fidelityfusion_tpu/models/cigp.py` (`CIGP`, `GPBasic` and
`CIGPWithMean`).  CIGP: one shared kernel and scalar
noise across output columns, the NLML summed over columns, ``noise =
exp(log_beta)^-1`` with a relative floor ``min_noise * mean(diag K)``.
GPBasic: the same with ``noise = noise_variance^2`` and predictions
without the noise.  CIGPWithMean: a CIGP of ``y - c`` with a trainable
constant mean ``c`` (``params["const_mean"]``).  Each model is a static spec plus a parameter dict.

Parameter leaves may carry a leading restart dimension; ``y`` is then
``(*batch, n, d)`` or a shared ``(n, d)`` (a 1-D ``(n,)`` is one column),
and ``y_var`` ``(*batch, n)`` or ``(n,)``.  For an SE-form kernel Sigma is
built in one K1 pass (Gram + noise + jitter + y_var on the diagonal); the
mask is a torch op after it.

``CIGP(x64_factor=True)`` is the JAX package's float64 island: the Gram
(`Kernel.dense`, the JAX formula), the noise assembly, the Cholesky, the
solves and the log-determinant run in plain float64 PyTorch
(`torch.linalg.cholesky`, cuSOLVER on the card), never through the float32
kernels, and the gradients reach the float32 parameters through the cast.
Unbatched and unmasked only; the data get no gradient (as in JAX).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from fidelityfusion_tpu_torch.ops import fused_se, linalg
from fidelityfusion_tpu_torch.ops.kernels import Kernel, SquaredExponentialKernel
from fidelityfusion_tpu_torch.utils.device import resolve_device
from fidelityfusion_tpu_torch.utils.tree import tree_map

JITTER = linalg.JITTER
# rows from which one SE matrix trains through the analytic NLML
# (`ops/fused_se.py:se_nlml`), the JAX package's default
SE_ANALYTIC_MIN_N = 512


def _targets(y):
    """Targets as ``(n, d)`` or ``(*batch, n, d)``: a 1-D ``(n,)`` gains its
    column."""
    return y[:, None] if y.ndim == 1 else y


def build_sigma(gp, params, x, y_var=None, mask=None):
    """Sigma = K + (noise + jitter) I (+ diag(y_var)) of a CIGP or GPBasic
    ``gp``, masked rows -> identity.  ``gp.noise(params, mean(diag K))``
    gives the noise.  An SE-form kernel's mean diagonal is its signal
    variance, and K1 adds the diagonal in the Gram's own pass; any other
    kernel's Gram is built first and `linalg.assemble_sigma` adds it."""
    kp = params["kernel"]
    if not gp.kernel.SE_FORM:
        K = gp.kernel.apply(kp, x, x)
        k_mean = K.diagonal(dim1=-2, dim2=-1).mean(-1)
        return linalg.assemble_sigma(K, gp.noise(params, k_mean), jitter=gp.jitter,
                                     y_var=y_var, mask=mask,
                                     relative_jitter=gp.relative_jitter)
    sv = gp.kernel.signal_variance(kp)  # mean(diag K)
    jit = gp.jitter * sv if gp.relative_jitter else gp.jitter
    Sigma = gp.kernel.apply(kp, x, x, diag_add=gp.noise(params, sv) + jit, y_var=y_var)
    return Sigma if mask is None else linalg.apply_mask(Sigma, mask)


@dataclasses.dataclass(frozen=True)
class CIGP:
    """Static spec of a conditionally-independent multi-output GP: the JAX
    package's fields, less the four that choose its NLML route (`nll`
    chooses from what it is given)."""

    kernel: Kernel
    jitter: float = JITTER
    relative_jitter: bool = False
    # f32 RELATIVE noise floor: bounds cond(Sigma) <= n / min_noise
    min_noise: float = 1e-4
    # one unmasked SE matrix of >= SE_ANALYTIC_MIN_N rows trains through
    # `ops/fused_se.py:se_nlml` (see `nll`)
    se_analytic_nll: bool = True
    # float64 Gram, factorization and posterior for Sigmas beyond float32
    x64_factor: bool = False

    def init_params(self, input_dim: int, log_beta: float = 1.0, device="cuda"):
        device = resolve_device(device)
        return {
            "kernel": self.kernel.init_params(input_dim, device=device),
            "log_beta": torch.tensor([log_beta], device=device),
        }

    def noise(self, params, K_diag_mean=1.0) -> torch.Tensor:
        noise = torch.exp(-params["log_beta"][..., 0])
        return torch.maximum(noise, torch.as_tensor(self.min_noise * K_diag_mean,
                                                    dtype=noise.dtype, device=noise.device))

    def _sigma64(self, params, x, y_var=None, mask=None):
        """The float64 Sigma of the ``x64_factor`` island and its noise: the
        noise is the float32 parameter's, floored by the float64 Gram's
        mean diagonal taken to float32 (the JAX package's order)."""
        if mask is not None:
            raise NotImplementedError(
                "x64_factor does not support masked/padded training "
                "(the escape hatch targets ill-conditioned exact solves)")
        f64 = torch.float64
        kp = tree_map(lambda a: a.to(f64), params["kernel"])
        K = self.kernel.dense(kp, x.detach().to(f64), x.detach().to(f64))
        noise = self.noise(params, K.diagonal().mean().to(torch.float32)).to(f64)
        yv = None if y_var is None else y_var.detach().to(f64)
        Sigma = linalg.assemble_sigma(K, noise, jitter=self.jitter, y_var=yv,
                                      relative_jitter=self.relative_jitter)
        return Sigma, noise, kp

    def nll64(self, params, x, y, y_var=None, mask=None) -> torch.Tensor:
        """The ``x64_factor`` island's NLML in float64, before `nll` casts it
        to float32."""
        Sigma, _, _ = self._sigma64(params, x, y_var, mask)
        y64 = _targets(y).detach().to(torch.float64)
        L = _chol64(Sigma)
        gamma = torch.linalg.solve_triangular(L, y64, upper=False)
        n, d = y64.shape
        return (0.5 * (gamma * gamma).sum() + d * torch.log(L.diagonal()).sum()
                + 0.5 * n * d * linalg.LOG2PI)

    def _predict_x64(self, params, x_train, y_train, x_test, y_var=None, mask=None,
                     diag=True):
        """The float64 posterior (factorization and cross-Gram), returned in
        float32."""
        with torch.no_grad():
            Sigma, noise, kp = self._sigma64(params, x_train, y_var, mask)
            f64 = torch.float64
            xtr, xte = x_train.to(f64), x_test.to(f64)
            L = _chol64(Sigma)
            K_s = self.kernel.dense(kp, xtr, xte)
            alpha = torch.cholesky_solve(_targets(y_train).to(f64), L)
            v = torch.linalg.solve_triangular(L, K_s, upper=False)
            mean = K_s.T @ alpha
            if diag:
                var = torch.clamp(self.kernel.diag(kp, xte) - (v * v).sum(0), min=0.0)
                out = (mean, var + noise)
            else:
                cov = _clamp_diag(self.kernel.dense(kp, xte, xte) - v.T @ v) + noise
                out = (mean, cov)
        return tuple(o.to(torch.float32) for o in out)

    def nll(self, params, x, y, y_var=None, mask=None) -> torch.Tensor:
        """Negative log marginal likelihood (``(*batch)``) to minimize: the
        float64 island under ``x64_factor``; the analytic SE NLML
        (`ops/fused_se.py:se_nlml`) for one SE matrix (no restart axis) of
        at least `SE_ANALYTIC_MIN_N` rows, without mask, targets' variances
        or relative jitter; else `linalg.mvn_nll` of `build_sigma`'s Sigma
        (K1, K2/K3a + K3b, and K4 from `linalg.NLL_GRAD_MIN_N` rows)."""
        if self.x64_factor:
            return self.nll64(params, x, y, y_var, mask).to(torch.float32)
        y2 = _targets(y)
        if (self.se_analytic_nll
                and type(self.kernel) is SquaredExponentialKernel
                and "log_beta" in params
                and mask is None and y_var is None and not self.relative_jitter
                and x.shape[0] >= SE_ANALYTIC_MIN_N
                and params["log_beta"].ndim == 1):
            return fused_se.se_nlml(params, x, y2, self.jitter, min_noise=self.min_noise)
        return linalg.mvn_nll(build_sigma(self, params, x, y_var, mask), y2, mask=mask)

    def _noise_out(self, params, x_train):
        """The noise added to predictive variances, floored by the mean
        prior variance at the training inputs."""
        kp = params["kernel"]
        if self.kernel.SE_FORM:
            return self.noise(params, self.kernel.signal_variance(kp))
        return self.noise(params, self.kernel.diag(kp, x_train).mean(-1))

    def predict(self, params, x_train, y_train, x_test, y_var=None,
                mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Posterior mean and full test covariance plus the noise."""
        if self.x64_factor:
            return self._predict_x64(params, x_train, y_train, x_test, y_var, mask, diag=False)
        Sigma = build_sigma(self, params, x_train, y_var, mask)
        K_s = self.kernel.apply(params["kernel"], x_train, x_test)
        K_ss = self.kernel.apply(params["kernel"], x_test, x_test)
        mean, cov = linalg.posterior(Sigma, y_train, K_s, K_ss, mask=mask)
        return mean, _clamp_diag(cov) + self._noise_out(params, x_train)

    def predict_diag(self, params, x_train, y_train, x_test, y_var=None,
                     mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Posterior mean and diagonal variance plus the noise."""
        if self.x64_factor:
            return self._predict_x64(params, x_train, y_train, x_test, y_var, mask, diag=True)
        Sigma = build_sigma(self, params, x_train, y_var, mask)
        K_s = self.kernel.apply(params["kernel"], x_train, x_test)
        k_ss = self.kernel.diag(params["kernel"], x_test)
        mean, var = linalg.posterior_diag(Sigma, y_train, K_s, k_ss, mask=mask)
        return mean, var + self._noise_out(params, x_train)

    def posterior_cache(self, params, x_train, y_train, y_var=None, mask=None) -> dict:
        """One-time (inv(L), alpha) factorization of the training set (the
        float32 factorization, as in the JAX package, whatever
        ``x64_factor``)."""
        Sigma = build_sigma(self, params, x_train, y_var, mask)
        return linalg.posterior_cache(Sigma, y_train, mask=mask)

    def predict_diag_cached(self, params, cache, x_train, x_test, mask=None):
        """`predict_diag` from a `posterior_cache`: cross-Gram + GEMMs."""
        K_s = self.kernel.apply(params["kernel"], x_train, x_test)
        k_ss = self.kernel.diag(params["kernel"], x_test)
        mean, var = linalg.posterior_diag_cached(cache, K_s, k_ss, mask=mask)
        return mean, var + self._noise_out(params, x_train)

    def predict_cached(self, params, cache, x_train, x_test, mask=None):
        """`predict` (full covariance + noise) from a `posterior_cache`."""
        K_s = self.kernel.apply(params["kernel"], x_train, x_test)
        K_ss = self.kernel.apply(params["kernel"], x_test, x_test)
        mean, cov = linalg.posterior_cached(cache, K_s, K_ss, mask=mask)
        return mean, _clamp_diag(cov) + self._noise_out(params, x_train)


@dataclasses.dataclass(frozen=True)
class GPBasic:
    """Exact GP with a directly parametrized noise std: ``noise =
    max(noise_variance^2, min_noise * mean(diag K))``.  Unlike CIGP, its
    predictions do not add the noise (the JAX package's
    `cigp.py:GPBasic.predict`)."""

    kernel: Kernel
    jitter: float = JITTER
    relative_jitter: bool = False
    min_noise: float = 1e-4  # f32 RELATIVE nugget floor (see CIGP.min_noise)

    def init_params(self, input_dim: int, noise_variance: float = 1.0, device="cuda"):
        device = resolve_device(device)
        return {
            "kernel": self.kernel.init_params(input_dim, device=device),
            "noise_variance": torch.tensor([noise_variance], device=device),
        }

    def noise(self, params, K_diag_mean=1.0) -> torch.Tensor:
        noise = params["noise_variance"][..., 0] ** 2
        return torch.maximum(noise, torch.as_tensor(self.min_noise * K_diag_mean,
                                                    dtype=noise.dtype, device=noise.device))

    def nll(self, params, x, y, y_var=None, mask=None) -> torch.Tensor:
        """Negative log marginal likelihood (``(*batch)``): K2/K3a + K3b."""
        return linalg.mvn_nll(build_sigma(self, params, x, y_var, mask), y, mask=mask)

    def predict(self, params, x_train, y_train, x_test, y_var=None,
                mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Posterior mean and full test covariance, without the noise."""
        Sigma = build_sigma(self, params, x_train, y_var, mask)
        K_s = self.kernel.apply(params["kernel"], x_train, x_test)
        K_ss = self.kernel.apply(params["kernel"], x_test, x_test)
        return linalg.posterior(Sigma, y_train, K_s, K_ss, mask=mask)

    def predict_diag(self, params, x_train, y_train, x_test, y_var=None,
                     mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Posterior mean and diagonal variance, without the noise."""
        Sigma = build_sigma(self, params, x_train, y_var, mask)
        K_s = self.kernel.apply(params["kernel"], x_train, x_test)
        k_ss = self.kernel.diag(params["kernel"], x_test)
        return linalg.posterior_diag(Sigma, y_train, K_s, k_ss, mask=mask)



@dataclasses.dataclass(frozen=True)
class CIGPWithMean:
    """CIGP with a constant trainable mean (the JAX package's
    `cigp.py:CIGPWithMean`, after `GaussianProcess/cigp_withMean.py:29-127`):
    the GP models ``y - c`` with a trainable scalar (or per-column)
    constant ``c``; normalization stays with the caller."""

    kernel: Kernel
    jitter: float = JITTER

    def init_params(self, input_dim: int, output_dim: int = 1, log_beta: float = 1.0,
                    y=None, device="cuda"):
        """``y`` (optional training targets) starts the constant mean at
        their float32 mean; starting at 0 under a large offset drives the
        kernel variance into an ill-conditioned rank-1 regime."""
        device = resolve_device(device)
        c = 0.0 if y is None else float(torch.as_tensor(y, dtype=torch.float32).mean())
        return {
            "kernel": self.kernel.init_params(input_dim, device=device),
            "log_beta": torch.tensor([log_beta], device=device),
            "const_mean": torch.full((output_dim,), c, device=device),
        }

    def _gp(self) -> CIGP:
        return CIGP(kernel=self.kernel, jitter=self.jitter)

    def nll(self, params, x, y, y_var=None, mask=None) -> torch.Tensor:
        return self._gp().nll(params, x, _targets(y) - params["const_mean"][None, :],
                              y_var=y_var, mask=mask)

    def predict(self, params, x_train, y_train, x_test, y_var=None,
                mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Posterior mean (the constant restored) and full test covariance
        plus the noise."""
        c = params["const_mean"][None, :]
        mean, cov = self._gp().predict(params, x_train, _targets(y_train) - c, x_test,
                                       y_var=y_var, mask=mask)
        return mean + c, cov

def _chol64(Sigma):
    """Cholesky factor of the float64 island, NaN where Sigma is not
    positive definite (`jnp.linalg.cholesky`'s answer; `torch.linalg.
    cholesky` would raise), so the trainer's rollback sees a NaN loss."""
    L, info = torch.linalg.cholesky_ex(Sigma)
    return torch.where(info == 0, L, torch.full_like(L, float("nan")))


def _clamp_diag(cov):
    """Clamp tiny negative roundoff variances on the diagonal to zero."""
    d = cov.diagonal(dim1=-2, dim2=-1)
    return cov + torch.diag_embed(torch.clamp(d, min=0.0) - d)
