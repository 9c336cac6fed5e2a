"""Covariance kernels as static specs over parameter dicts of tensors.

Port of `fidelityfusion_tpu/ops/kernels.py` (the parts the CIGP cascades
need: `sq_dist`, `Kernel`, `ARDKernel`, `SquaredExponentialKernel`,
`MCFidelityKernel`, `median_heuristic`, `trainable_mask`).  A spec is a
frozen dataclass that holds no tensors:

    params = spec.init_params(input_dim, device=...)   # dict of tensors
    K      = spec(params, x1, x2)                      # (*batch, n1, n2)

Parameter leaves may carry a leading batch dimension (the restart axis);
the Gram then has the same batch.  The Gram itself is K1 (`ops/gram.py`):
every kernel here is an SE form ``sv * exp(-0.5 ||(x1 - x2) / ls||^2)``,
so each only says what its ``1/ls`` and ``sv`` are (`gram_args`), and the
noise diagonal can ride in the same pass (``diag_add``, ``y_var``).

Parametrizations follow the JAX package exactly: ARD ``ls = |raw| + eps``,
``sv = |raw|``; scalar SE ``ls = exp(t)``, ``sv = exp(u)^2``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from fidelityfusion_tpu_torch.ops.gram import gram

EPS = 1e-9


def sq_dist(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances ``(n1, d), (n2, d) -> (n1, n2)`` by the
    quadratic expansion, clamped at zero.  The cross term is a full-fp32
    product (TF32 would cancel catastrophically here); the Gram kernels
    do not use this function, they take direct differences."""
    n1 = (x1 * x1).sum(-1)[:, None]
    n2 = (x2 * x2).sum(-1)[None, :]
    return torch.clamp(n1 + n2 - 2.0 * (x1 @ x2.T), min=0.0)


def _linspace_rows(n: int, num: int) -> torch.Tensor:
    """``jnp.linspace(0, n - 1, num).astype(int32)``, reproduced in float32
    (start * (1 - step) + stop * step with step = iota / (num - 1), then
    truncation)."""
    div = num - 1
    step = torch.arange(div, dtype=torch.float32) / torch.tensor(float(div), dtype=torch.float32)
    vals = torch.tensor(float(n - 1), dtype=torch.float32) * step
    return torch.cat([vals, torch.tensor([float(n - 1)])]).to(torch.int64)


def median_heuristic(x: torch.Tensor, max_rows: int = 256) -> torch.Tensor:
    """Per-dimension median of pairwise |x_i - x_j| over at most
    ``max_rows`` evenly spaced rows, floored at 1e-3.  The median of an
    even count is the mean of the two middle values (`jnp.median`), not
    the lower one (`torch.median`)."""
    if x.shape[0] > max_rows:
        x = x[_linspace_rows(x.shape[0], max_rows).to(x.device)]
    diffs = (x[:, None, :] - x[None, :, :]).abs().reshape(-1, x.shape[-1])
    s = diffs.sort(dim=0).values
    m = s.shape[0]
    med = (s[(m - 1) // 2] + s[m // 2]) / 2
    return torch.clamp(med, min=1e-3)


class Kernel:
    """Base class: a static spec; subclasses define `init_params` and
    `gram_args`.  A kernel whose Gram is not an SE form (`models/car.py:
    ContinuousFidelityKernel`) sets ``SE_FORM = False`` and overrides
    `apply` and `diag` instead."""

    SE_FORM = True

    def init_params(self, input_dim: int, device="cuda") -> dict:
        raise NotImplementedError

    def gram_args(self, params, d: int):
        """``(inv_ls (*batch, d), sv (*batch))`` of the SE form."""
        raise NotImplementedError

    def apply(self, params, x1, x2, diag_add=None, y_var=None):
        inv_ls, sv = self.gram_args(params, x1.shape[-1])
        return gram(x1, x2, inv_ls, sv, diag_add=diag_add, y_var=y_var)

    def __call__(self, params, x1, x2):
        return self.apply(params, x1, x2)

    def signal_variance(self, params) -> torch.Tensor:
        """k(x, x), the constant diagonal of the Gram, shape ``(*batch)``."""
        return self.gram_args(params, 1)[1]

    def diag(self, params, x):
        sv = self.signal_variance(params)
        return sv[..., None].expand(sv.shape + (x.shape[0],))

    def set_lengthscales(self, params, ls):
        return params


@dataclasses.dataclass(frozen=True)
class ARDKernel(Kernel):
    """SE kernel with per-dimension length scales:
    k = |sv| exp(-0.5 ||x/ls - x'/ls||^2),  ls = |raw_ls| + eps."""

    eps: float = EPS

    def init_params(self, input_dim: int, device="cuda"):
        return {
            "length_scales": torch.ones((input_dim,), device=device),
            "signal_variance": torch.ones((1,), device=device),
        }

    def gram_args(self, params, d):
        ls = torch.abs(params["length_scales"]) + self.eps
        return 1.0 / ls, torch.abs(params["signal_variance"][..., 0])

    def set_lengthscales(self, params, ls):
        out = dict(params)
        ls = torch.as_tensor(ls, dtype=torch.float32).reshape(-1)
        shape = params["length_scales"].shape
        if ls.shape[0] != shape[0]:
            ls = torch.full(shape, float(ls.mean()), dtype=torch.float32)
        out["length_scales"] = ls.to(params["length_scales"].device)
        return out


@dataclasses.dataclass(frozen=True)
class SquaredExponentialKernel(Kernel):
    """Scalar-length-scale SE kernel, exp parametrization:
    k = exp(u)^2 exp(-0.5 ||x - x'||^2 / exp(t)^2)."""

    def init_params(self, input_dim: int, device="cuda"):
        del input_dim
        return {
            "length_scale": torch.ones((1,), device=device),
            "signal_variance": torch.ones((1,), device=device),
        }

    def gram_args(self, params, d):
        t = params["length_scale"][..., 0]
        inv_ls = torch.exp(-t)[..., None].expand(t.shape + (d,))
        return inv_ls, torch.exp(params["signal_variance"][..., 0]) ** 2

    def set_lengthscales(self, params, ls):
        out = dict(params)
        mean = torch.as_tensor(ls, dtype=torch.float32).mean()
        out["length_scale"] = torch.log(mean).reshape(1).to(params["length_scale"].device)
        return out


@dataclasses.dataclass(frozen=True)
class MCFidelityKernel(Kernel):
    """A base kernel over x times a Monte-Carlo integrated fidelity factor
    over z in [lf, hf] (staged CAR's residual kernel):

        factor = mean_z[exp(-b (z1 - hf) - b (z2 - hf) - 0.5 (z1 - z2)^2 / ls^2)]
                 * (hf - lf)^2,   k = |sv| * factor * base(x1, x2).

    The factor is one scalar per restart, so the Gram is still an SE form:
    `gram_args` is the base kernel's ``1/ls`` and ``|sv| * factor *
    base_sv``, and K1 builds Gram and nugget in one pass.  The z draws are
    drawn once from ``torch.Generator().manual_seed(seed)`` (the JAX package
    draws its own with `jax.random`; `convert.py` carries those across) and
    kept under ``"_z"``, which training leaves frozen.  ``b`` is a
    parameter here so that staged CAR can bind its one global ``b`` in."""

    base: Kernel
    lf: float = 0.0
    hf: float = 1.0
    n_mc: int = 100
    seed: int = 105
    eps: float = 1e-3

    def init_params(self, input_dim: int, device="cuda"):
        gen = torch.Generator().manual_seed(self.seed)
        width = self.hf - self.lf
        z1 = torch.rand((self.n_mc,), generator=gen) * width + self.lf
        z2 = torch.rand((self.n_mc,), generator=gen) * width + self.lf
        return {
            "base": self.base.init_params(input_dim, device=device),
            "length_scales": torch.ones((input_dim,), device=device),
            "signal_variance": torch.ones((1,), device=device),
            "b": torch.tensor(1.0, device=device),
            "_z": (z1.to(device), z2.to(device)),
        }

    def fidelity_factor(self, params) -> torch.Tensor:
        """The factor, shape ``(*batch)``."""
        ls = (torch.abs(params["length_scales"]) + self.eps)[..., :1]
        z1, z2 = params["_z"]
        b = params["b"][..., None]
        dist_z = (z1 / ls - z2 / ls) ** 2
        expo = -b * (z1 - self.hf) - b * (z2 - self.hf) - 0.5 * dist_z
        z_part = torch.exp(torch.clamp(expo, max=20.0))  # overflow guard
        return z_part.mean(-1) * (self.hf - self.lf) * (self.hf - self.lf)

    def gram_args(self, params, d):
        inv_ls, base_sv = self.base.gram_args(params["base"], d)
        sv = torch.abs(params["signal_variance"][..., 0]) * self.fidelity_factor(params)
        return inv_ls, sv * base_sv

    def set_lengthscales(self, params, ls):
        out = dict(params)
        out["base"] = self.base.set_lengthscales(params["base"], ls)
        return out


def trainable_mask(kernel: Optional[Kernel], params) -> dict:
    """Nested dict of bools marking trainable leaves: everything under a
    key starting with "_" is a frozen constant."""

    def walk(subtree, frozen):
        if isinstance(subtree, dict):
            return {k: walk(v, frozen or k.startswith("_")) for k, v in subtree.items()}
        if isinstance(subtree, (list, tuple)):
            return type(subtree)(walk(v, frozen) for v in subtree)
        return not frozen

    return walk(params, False)
