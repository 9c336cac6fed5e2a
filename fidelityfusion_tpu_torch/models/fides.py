"""FIDES: a GP over inputs whose kernel integrates over fidelity intervals.

Port of `fidelityfusion_tpu/models/fides.py`: k(x, x'; bounds) = factor *
scale * SE(x / ls, x' / ls), where ``bounds = (l1, h1, l2, h2)`` are the
two fidelity intervals and the factor is a Monte-Carlo integral over them
(the continuous-fidelity BO surrogate).  The factor is one scalar, so the
Gram is an SE form and K1 builds it with its nugget in one pass
(`gram_args`).  Parameters are stored as logs (length scale, scale, z
length scale, noise precision) with ``b`` raw; the MC draws are drawn once
from ``torch.Generator().manual_seed(seed)`` and kept under ``"_u"``,
which training leaves frozen (`convert.py` carries the JAX package's
draws across).  The model stores no data: callers pass (x, y).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from fidelityfusion_tpu_torch.ops import linalg
from fidelityfusion_tpu_torch.ops.gram import gram
from fidelityfusion_tpu_torch.utils.device import resolve_device

JITTER = linalg.JITTER


class FidelityBounds(NamedTuple):
    l1: float
    h1: float
    l2: float
    h2: float


@dataclasses.dataclass(frozen=True)
class FIDES:
    """Static spec; the parameter dict holds the kernel and noise
    parameters."""

    n_mc: int = 100
    seed: int = 1024
    jitter: float = JITTER

    def init_params(self, input_dim: int, device="cuda"):
        del input_dim  # one (log) length scale
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(self.seed)
        u1 = torch.rand((self.n_mc,), generator=gen)
        u2 = torch.rand((self.n_mc,), generator=gen)
        zeros = lambda: torch.zeros((1,), device=device)  # noqa: E731
        return {
            "log_length_scale": zeros(),
            "log_scale": zeros(),
            "log_length_scale_z": zeros(),
            "b": torch.tensor(1.0, device=device),
            "log_noise": zeros(),
            "_u": (u1.to(device), u2.to(device)),
        }

    def gram_args(self, params, d: int, bounds: FidelityBounds):
        """``(inv_ls (d,), sv ())`` of the SE form: sv = factor * scale."""
        lz = torch.exp(params["log_length_scale_z"][0])
        b = params["b"]
        u1, u2 = params["_u"]
        z1 = u1 * (bounds.h1 - bounds.l1) + bounds.l1
        z2 = u2 * (bounds.h2 - bounds.l2) + bounds.l2
        dist_z = (z1 / lz - z2 / lz) ** 2
        z_part = torch.exp(-b * (z1 - bounds.h1) - b * (z2 - bounds.h2) - 0.5 * dist_z)
        factor = z_part.mean() * (bounds.h1 - bounds.l1) * (bounds.h2 - bounds.l2)
        inv_ls = torch.exp(-params["log_length_scale"]).expand(d)
        return inv_ls, factor * torch.exp(params["log_scale"][0])

    def kernel(self, params, x1, x2, bounds: FidelityBounds, diag_add=None) -> torch.Tensor:
        """The Gram (K1), with ``diag_add`` on a square Gram's diagonal."""
        inv_ls, sv = self.gram_args(params, x1.shape[-1], bounds)
        return gram(x1, x2, inv_ls, sv, diag_add=diag_add)

    def noise(self, params) -> torch.Tensor:
        """The noise variance: the inverse of ``exp(log_noise)``."""
        return 1.0 / torch.exp(params["log_noise"][0])

    def _sigma(self, params, x, bounds, mask=None):
        Sigma = self.kernel(params, x, x, bounds, diag_add=self.noise(params) + self.jitter)
        return Sigma if mask is None else linalg.apply_mask(Sigma, mask)

    def nll(self, params, x, y, bounds: FidelityBounds,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Negative log marginal likelihood (K2 + K3b)."""
        return linalg.mvn_nll(self._sigma(params, x, bounds, mask), y, mask=mask)

    def predict(self, params, x_train, y_train, x_test, bounds: FidelityBounds,
                mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Mean and diagonal variance plus the noise, ``(m, 1)``."""
        Sigma = self._sigma(params, x_train, bounds, mask)
        K_s = self.kernel(params, x_train, x_test, bounds)
        k_ss = self.gram_args(params, x_test.shape[-1], bounds)[1].expand(x_test.shape[0])
        mean, var = linalg.posterior_diag(Sigma, y_train, K_s, k_ss, mask=mask)
        return mean, (var + self.noise(params)).reshape(-1, 1)

    def predict_full(self, params, x_train, y_train, x_test,
                     bounds: FidelityBounds) -> Tuple[torch.Tensor, torch.Tensor]:
        """Posterior mean ``(m,)`` and full covariance over the test points,
        without the noise; the solves are products with W = inv(L)."""
        Sigma = self._sigma(params, x_train, bounds)
        K_s = self.kernel(params, x_train, x_test, bounds)
        K_ss = self.kernel(params, x_test, x_test, bounds)
        _, W = linalg._factor(Sigma)
        V = W @ K_s
        alpha = W.T @ (W @ y_train.reshape(-1, 1))
        return (K_s.T @ alpha).reshape(-1), K_ss - V.T @ V
