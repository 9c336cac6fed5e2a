"""CIGP and GPBasic: exact GPs over one kernel.

Port of `fidelityfusion_tpu/models/cigp.py` (`CIGP` and `GPBasic`;
`CIGPWithMean` is not ported yet).  CIGP: one shared kernel and scalar
noise across output columns, the NLML summed over columns, ``noise =
exp(log_beta)^-1`` with a relative floor ``min_noise * mean(diag K)``.
GPBasic: the same with ``noise = noise_variance^2`` and predictions
without the noise.  Each model is a static spec plus a parameter dict.

Parameter leaves may carry a leading restart dimension; ``y`` is then
``(*batch, n, d)`` or a shared ``(n, d)`` (a 1-D ``(n,)`` is one column),
and ``y_var`` ``(*batch, n)`` or ``(n,)``.  For an SE-form kernel Sigma is
built in one K1 pass (Gram + noise + jitter + y_var on the diagonal); the
mask is a torch op after it.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from fidelityfusion_tpu_torch.ops import linalg
from fidelityfusion_tpu_torch.ops.kernels import Kernel
from fidelityfusion_tpu_torch.utils.device import resolve_device

JITTER = linalg.JITTER


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
    """Static spec of a conditionally-independent multi-output GP; the
    fields and the NLML dispatch order are the JAX package's."""

    kernel: Kernel
    jitter: float = JITTER
    relative_jitter: bool = False
    fused_nll: bool = True
    # GEMM-only batched NLML (ops/blocked.py:mvn_nll_blocked); the restart
    # trainer turns it on for stages of >= 320 rows (models/ar.py)
    blocked_nll: bool = False
    hybrid_nll: bool = True
    hybrid_min_n: int = 512
    # f32 RELATIVE noise floor: bounds cond(Sigma) <= n / min_noise
    min_noise: float = 1e-4
    se_analytic_nll: bool = True
    # the float64 factorization of the JAX package; not ported yet
    x64_factor: bool = False

    def init_params(self, input_dim: int, log_beta: float = 1.0, device="cuda"):
        device = resolve_device(device)
        return {
            "kernel": self.kernel.init_params(input_dim, device=device),
            "log_beta": torch.tensor([log_beta], device=device),
        }

    def noise(self, params, K_diag_mean=1.0) -> torch.Tensor:
        return torch.maximum(torch.exp(-params["log_beta"][..., 0]),
                             self.min_noise * K_diag_mean)

    def _check_x64(self):
        if self.x64_factor:
            raise NotImplementedError("x64_factor is not ported yet")

    def nll(self, params, x, y, y_var=None, mask=None) -> torch.Tensor:
        """Negative log marginal likelihood (``(*batch)``) to minimize."""
        self._check_x64()
        y2 = _targets(y)
        if (
            self.se_analytic_nll
            and self.fused_nll
            and self.hybrid_nll
            and not self.blocked_nll
            and mask is None
            and y_var is None
            and not self.relative_jitter
            and x.shape[0] >= self.hybrid_min_n
            and type(self.kernel).__name__ == "SquaredExponentialKernel"
            and "log_beta" in params
        ):
            from fidelityfusion_tpu_torch.ops.fused_se import se_nlml

            return se_nlml(params, x, y2, self.jitter, min_noise=self.min_noise)
        Sigma = build_sigma(self, params, x, y_var, mask)
        if self.blocked_nll:
            from fidelityfusion_tpu_torch.ops.blocked import mvn_nll_blocked

            return mvn_nll_blocked(Sigma, y2, mask=mask)
        if self.fused_nll and mask is None:
            if self.hybrid_nll and x.shape[0] >= self.hybrid_min_n:
                from fidelityfusion_tpu_torch.ops.blocked import mvn_nll_hybrid

                return mvn_nll_hybrid(Sigma, y2)
            return linalg.mvn_nll_fused(Sigma, y2)
        return linalg.mvn_nll(Sigma, y2, mask=mask)

    def _noise_out(self, params):
        return self.noise(params, self.kernel.signal_variance(params["kernel"]))

    def predict(self, params, x_train, y_train, x_test, y_var=None,
                mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Posterior mean and full test covariance plus the noise."""
        self._check_x64()
        Sigma = build_sigma(self, params, x_train, y_var, mask)
        K_s = self.kernel.apply(params["kernel"], x_train, x_test)
        K_ss = self.kernel.apply(params["kernel"], x_test, x_test)
        mean, cov = linalg.posterior(Sigma, y_train, K_s, K_ss, mask=mask)
        return mean, _clamp_diag(cov) + self._noise_out(params)

    def predict_diag(self, params, x_train, y_train, x_test, y_var=None,
                     mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Posterior mean and diagonal variance plus the noise."""
        self._check_x64()
        Sigma = build_sigma(self, params, x_train, y_var, mask)
        K_s = self.kernel.apply(params["kernel"], x_train, x_test)
        k_ss = self.kernel.diag(params["kernel"], x_test)
        mean, var = linalg.posterior_diag(Sigma, y_train, K_s, k_ss, mask=mask)
        return mean, var + self._noise_out(params)

    def posterior_cache(self, params, x_train, y_train, y_var=None, mask=None) -> dict:
        """One-time (inv(L), alpha) factorization of the training set."""
        self._check_x64()
        Sigma = build_sigma(self, params, x_train, y_var, mask)
        return linalg.posterior_cache(Sigma, y_train, mask=mask)

    def predict_diag_cached(self, params, cache, x_train, x_test, mask=None):
        """`predict_diag` from a `posterior_cache`: cross-Gram + GEMMs."""
        K_s = self.kernel.apply(params["kernel"], x_train, x_test)
        k_ss = self.kernel.diag(params["kernel"], x_test)
        mean, var = linalg.posterior_diag_cached(cache, K_s, k_ss, mask=mask)
        return mean, var + self._noise_out(params)

    def predict_cached(self, params, cache, x_train, x_test, mask=None):
        """`predict` (full covariance + noise) from a `posterior_cache`."""
        K_s = self.kernel.apply(params["kernel"], x_train, x_test)
        K_ss = self.kernel.apply(params["kernel"], x_test, x_test)
        mean, cov = linalg.posterior_cached(cache, K_s, K_ss, mask=mask)
        return mean, _clamp_diag(cov) + self._noise_out(params)


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
        return torch.maximum(params["noise_variance"][..., 0] ** 2,
                             self.min_noise * K_diag_mean)

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


def _clamp_diag(cov):
    """Clamp tiny negative roundoff variances on the diagonal to zero."""
    d = cov.diagonal(dim1=-2, dim2=-1)
    return cov + torch.diag_embed(torch.clamp(d, min=0.0) - d)
