"""Covariance kernels as static specs over parameter dicts of tensors.

Port of `fidelityfusion_tpu/ops/kernels.py`.  A spec is a frozen
dataclass that holds no tensors:

    params = spec.init_params(input_dim, device=...)   # dict of tensors
    K      = spec(params, x1, x2)                      # (*batch, n1, n2)

Parameter leaves may carry a leading batch dimension (the restart axis);
the Gram then has the same batch.  The Gram itself is K1 (`ops/gram.py`):
every kernel here is an SE form ``sv * exp(-0.5 ||(x1 - x2) / ls||^2)``,
so each only says what its ``1/ls`` and ``sv`` are (`gram_args`), and the
noise diagonal can ride in the same pass (``diag_add``, ``y_var``).

The other kernels (`MaternKernel`, `LinearKernel`,
`RationalQuadraticKernel`, `SumKernel`, `ProductKernel`,
`MaternKernelScalarLengthScale`) are not SE forms: they set ``SE_FORM =
False`` and build their Gram in plain PyTorch by the JAX package's
formulas (the JAX package computes them in XLA, not in a Pallas kernel),
so a CIGP over one of them adds its nugget afterwards
(`models/cigp.py:build_sigma`).

Parametrizations follow the JAX package exactly: ARD and Matern ``ls =
|raw| + eps``, ``sv = |raw|``; scalar SE ``ls = exp(t)``, ``sv = exp(u)^2``.
`Kernel.dense` is any kernel's Gram in plain PyTorch in the inputs' dtype
by the JAX formula (the float64 island of `CIGP(x64_factor=True)`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from fidelityfusion_tpu_torch.ops.gram import gram

EPS = 1e-9


def sq_dist(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances ``(*batch, n1, d), (*batch, n2, d) ->
    (*batch, n1, n2)`` by the quadratic expansion, clamped at zero.  The
    cross term is a full-precision product in the inputs' dtype (TF32
    would cancel catastrophically here); K1 does not use this function, it
    takes direct differences."""
    n1 = (x1 * x1).sum(-1)[..., :, None]
    n2 = (x2 * x2).sum(-1)[..., None, :]
    return torch.clamp(n1 + n2 - 2.0 * (x1 @ x2.transpose(-1, -2)), min=0.0)


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

    def dense(self, params, x1, x2):
        """The unbatched Gram in plain PyTorch, in the inputs' dtype."""
        inv_ls, sv = self.gram_args(params, x1.shape[-1])
        return sv * torch.exp(-0.5 * sq_dist(x1 * inv_ls, x2 * inv_ls))


class _DenseKernel(Kernel):
    """A kernel whose Gram is not an SE form: `apply` builds it in plain
    PyTorch (any dtype, parameters with an optional leading batch) and adds
    ``diag_add`` / ``y_var`` to a square Gram's diagonal after it; its
    diagonal is that of `apply` (the JAX package's default)."""

    SE_FORM = False

    def gram(self, params, x1, x2):
        raise NotImplementedError

    def apply(self, params, x1, x2, diag_add=None, y_var=None):
        K = self.gram(params, x1, x2)
        if diag_add is None and y_var is None:
            return K
        extra = torch.zeros(K.shape[:-1], dtype=K.dtype, device=K.device)
        if diag_add is not None:
            extra = extra + torch.as_tensor(diag_add, dtype=K.dtype)[..., None]
        if y_var is not None:
            extra = extra + y_var
        return K + torch.diag_embed(extra)

    def diag(self, params, x):
        return self.apply(params, x, x).diagonal(dim1=-2, dim2=-1)

    def dense(self, params, x1, x2):
        return self.apply(params, x1, x2)


def _col(a):
    """A ``(*batch, 1)`` parameter's value as ``(*batch, 1, 1)``."""
    return a[..., None]


def _rows(a):
    """A ``(*batch, d)`` parameter as ``(*batch, 1, d)``, to scale ``(n, d)``
    inputs."""
    return a[..., None, :]


def _set_ard_lengthscales(params, ls):
    out = dict(params)
    ls = torch.as_tensor(ls, dtype=torch.float32).reshape(-1)
    shape = params["length_scales"].shape
    if ls.shape[0] != shape[0]:
        # e.g. HOGP shares a dim-1 kernel across modes: collapse to mean
        ls = torch.full(shape, float(ls.mean()), dtype=torch.float32)
    out["length_scales"] = ls.to(params["length_scales"].device)
    return out


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

    def dense(self, params, x1, x2):
        ls = torch.abs(params["length_scales"]) + self.eps
        return torch.abs(params["signal_variance"][0]) * torch.exp(
            -0.5 * sq_dist(x1 / ls, x2 / ls))

    def set_lengthscales(self, params, ls):
        return _set_ard_lengthscales(params, ls)


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

    def dense(self, params, x1, x2):
        ls2 = torch.exp(params["length_scale"][0]) ** 2
        sv2 = torch.exp(params["signal_variance"][0]) ** 2
        return sv2 * torch.exp(-0.5 * sq_dist(x1, x2) / ls2)

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


@dataclasses.dataclass(frozen=True)
class MaternKernel(_DenseKernel):
    """Matern kernel with ARD length scales, nu in {0.5, 1.5, 2.5} and a
    static ``rho``; ``eps`` floors the root (its gradient at 0)."""

    nu: float = 2.5
    rho: float = 1.0
    eps: float = EPS

    def init_params(self, input_dim: int, device="cuda"):
        return {
            "length_scales": torch.ones((input_dim,), device=device),
            "signal_variance": torch.ones((1,), device=device),
        }

    def gram(self, params, x1, x2):
        ls = _rows(torch.abs(params["length_scales"]) + self.eps)
        d2 = sq_dist(x1 / ls, x2 / ls)
        sv = _col(torch.abs(params["signal_variance"]))
        if self.nu == 0.5:
            d = torch.sqrt(d2 + self.eps)
            return sv * torch.exp(-d / self.rho)
        if self.nu == 1.5:
            d = torch.sqrt(3.0 * d2 + self.eps)
            return sv * (1.0 + d / self.rho) * torch.exp(-d / self.rho)
        if self.nu == 2.5:
            d = torch.sqrt(5.0 * d2 + self.eps)
            return (sv * (1.0 + d / self.rho + (5.0 / 3.0) * d2 / self.rho ** 2)
                    * torch.exp(-d / self.rho))
        raise ValueError(f"nu must be one of 0.5/1.5/2.5, got {self.nu}")

    def set_lengthscales(self, params, ls):
        return _set_ard_lengthscales(params, ls)


@dataclasses.dataclass(frozen=True)
class LinearKernel(_DenseKernel):
    """k(x, x') = |sv| <(x - c) / ls, (x' - c) / ls>, per-dimension scales
    and center."""

    def init_params(self, input_dim: int, device="cuda"):
        return {
            "length_scales": torch.ones((input_dim,), device=device),
            "signal_variance": torch.ones((1,), device=device),
            "center": torch.zeros((input_dim,), device=device),
        }

    def gram(self, params, x1, x2):
        ls, c = _rows(params["length_scales"]), _rows(params["center"])
        z1, z2 = (x1 - c) / ls, (x2 - c) / ls
        return _col(torch.abs(params["signal_variance"])) * (z1 @ z2.transpose(-1, -2))


@dataclasses.dataclass(frozen=True)
class RationalQuadraticKernel(_DenseKernel):
    """k = sv^2 (1 + d^2 / (2 alpha ls^2))^(-alpha), scalar length scale."""

    def init_params(self, input_dim: int, device="cuda"):
        del input_dim
        return {
            "length_scale": torch.ones((1,), device=device),
            "signal_variance": torch.ones((1,), device=device),
            "alpha": torch.ones((1,), device=device),
        }

    def gram(self, params, x1, x2):
        d2 = sq_dist(x1, x2)
        ls, sv, alpha = (_col(params[k]) for k in ("length_scale", "signal_variance", "alpha"))
        return sv ** 2 * torch.pow(1.0 + 0.5 * d2 / (alpha * ls ** 2), -alpha)


@dataclasses.dataclass(frozen=True)
class SumKernel(_DenseKernel):
    """k1 + k2."""

    k1: Kernel
    k2: Kernel

    def init_params(self, input_dim: int, device="cuda"):
        return {"k1": self.k1.init_params(input_dim, device=device),
                "k2": self.k2.init_params(input_dim, device=device)}

    def gram(self, params, x1, x2):
        return self.k1.apply(params["k1"], x1, x2) + self.k2.apply(params["k2"], x1, x2)

    def diag(self, params, x):
        return self.k1.diag(params["k1"], x) + self.k2.diag(params["k2"], x)

    def dense(self, params, x1, x2):
        return self.k1.dense(params["k1"], x1, x2) + self.k2.dense(params["k2"], x1, x2)

    def set_lengthscales(self, params, ls):
        return {"k1": self.k1.set_lengthscales(params["k1"], ls),
                "k2": self.k2.set_lengthscales(params["k2"], ls)}


@dataclasses.dataclass(frozen=True)
class ProductKernel(_DenseKernel):
    """k1 * k2."""

    k1: Kernel
    k2: Kernel

    def init_params(self, input_dim: int, device="cuda"):
        return {"k1": self.k1.init_params(input_dim, device=device),
                "k2": self.k2.init_params(input_dim, device=device)}

    def gram(self, params, x1, x2):
        return self.k1.apply(params["k1"], x1, x2) * self.k2.apply(params["k2"], x1, x2)

    def diag(self, params, x):
        return self.k1.diag(params["k1"], x) * self.k2.diag(params["k2"], x)

    def dense(self, params, x1, x2):
        return self.k1.dense(params["k1"], x1, x2) * self.k2.dense(params["k2"], x1, x2)

    def set_lengthscales(self, params, ls):
        return {"k1": self.k1.set_lengthscales(params["k1"], ls),
                "k2": self.k2.set_lengthscales(params["k2"], ls)}


@dataclasses.dataclass(frozen=True)
class MaternKernelScalarLengthScale(_DenseKernel):
    """The deprecated scalar-length-scale Matern variant:
    k = sv^2 (1 + sqrt(3 d^2) / ls^2)^(-nu), ``nu`` a parameter."""

    def init_params(self, input_dim: int, device="cuda"):
        del input_dim
        return {
            "length_scale": torch.ones((1,), device=device),
            "signal_variance": torch.ones((1,), device=device),
            "nu": torch.tensor([2.5], device=device),
        }

    def gram(self, params, x1, x2):
        d2 = sq_dist(x1, x2)
        ls, sv, nu = (_col(params[k]) for k in ("length_scale", "signal_variance", "nu"))
        return sv ** 2 * torch.pow(1.0 + torch.sqrt(3.0 * d2 + EPS) / ls ** 2, -nu)


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
