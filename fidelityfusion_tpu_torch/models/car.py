"""CAR / ContinuAR: continuous-fidelity autoregression.

Port of `fidelityfusion_tpu/models/car.py`:

* Staged CAR (`ContinuousAutoRegression`, `train_CAR`): a fidelity-0 GP
  plus residual GPs whose kernel is a base kernel times a Monte-Carlo
  integrated fidelity factor over z in [i, i+1] (`ops/kernels.py:
  MCFidelityKernel`), with one global trainable ``b`` shared by every
  residual kernel and by the recombination ``y_hi = exp(b) y_lo + res``.
  Each stage trains its restart batch through K1 + K3a + K3b.

* CAR-large (`ContinuousAutoRegressionLarge`, `train_CAR_large`): one GP
  over ``[x, s]`` (s the fidelity indicator) whose kernel multiplies
  k_x(x, x') by a PSD feature-map estimate of the ContinuAR double
  integral over the fidelity variable (`ContinuousFidelityKernel`).  Its
  factor is an n x n matrix, not a scalar, so the base Gram comes from K1
  alone, the product with ``f1 f2^T`` is a full-fp32 matmul, and the
  relative nugget is added afterwards; every step factors all the
  fidelities' rows stacked together through K2 + K3b.

MC draws come from explicit ``torch.Generator`` seeds and sit under ``_``
keys, which training leaves frozen.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from fidelityfusion_tpu_torch.models.ar import (
    _f32,
    _lift,
    _residual_norm,
    _run_stage,
    stage_x,
)
from fidelityfusion_tpu_torch.models.cigp import GPBasic
from fidelityfusion_tpu_torch.models.data_manager import MultiFidelityDataManager
from fidelityfusion_tpu_torch.ops.gram import gram
from fidelityfusion_tpu_torch.ops.kernels import Kernel, MCFidelityKernel
from fidelityfusion_tpu_torch.train.fit import fit
from fidelityfusion_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ContinuousFidelityKernel(Kernel):
    """Joint-input kernel of CAR-large: ``k([x, s], [x', s']) = |sv| *
    F(s, s') * k_x(x, x')`` with F(s1, s2) ~= phi(s1)^T phi(s2),

        phi_w(s) = s * mean_t[e^{-b s (1-t)} (cos, sin)(w s t / l_z)],

    random Fourier features of the SE factor over z plus shared MC samples
    of the z-integrals (``_w``, ``_t``): PSD by construction.  Unbatched:
    CAR-large trains without restarts."""

    SE_FORM = False

    base: Kernel
    n_features: int = 64
    n_mc: int = 64
    seed: int = 105
    eps: float = 1e-3

    def init_params(self, input_dim: int, device="cuda"):
        gen = torch.Generator().manual_seed(self.seed)
        w = torch.randn((self.n_features,), generator=gen)
        t = torch.rand((self.n_mc,), generator=gen)
        return {
            "base": self.base.init_params(input_dim, device=device),
            "length_scale_z": torch.ones((1,), device=device),
            "signal_variance": torch.ones((1,), device=device),
            "b": torch.tensor(1.0, device=device),
            "_w": w.to(device),
            "_t": t.to(device),
        }

    def features(self, params, s) -> torch.Tensor:
        """``(n, 2 * n_features)`` fidelity feature map phi(s): an (n,
        n_mc, n_features) temporary, 29 MB at n = 1792."""
        lz = torch.abs(params["length_scale_z"][0]) + self.eps
        b, w, t = params["b"], params["_w"], params["_t"]
        s3 = s.reshape(-1, 1, 1)
        decay = torch.exp(torch.clamp(-b * s3 * (1.0 - t[None, :, None]), max=20.0))
        phase = w[None, None, :] * s3 * t[None, :, None] / lz  # (n, T, F)
        cos_f = torch.mean(decay * torch.cos(phase), dim=1)
        sin_f = torch.mean(decay * torch.sin(phase), dim=1)
        feats = torch.cat([cos_f, sin_f], dim=-1) * s.reshape(-1, 1)
        return feats / math.sqrt(self.n_features)

    def apply(self, params, x1, x2):
        """|sv| * (phi(s1) phi(s2)^T) * K1(x1, x2); phi is computed once
        where ``x1 is x2`` (a training Gram)."""
        f1 = self.features(params, x1[:, -1])
        f2 = f1 if x2 is x1 else self.features(params, x2[:, -1])
        factor = f1 @ f2.T
        inv_ls, base_sv = self.base.gram_args(params["base"], x1.shape[-1] - 1)
        K_x = gram(x1[:, :-1], x2[:, :-1], inv_ls, base_sv)
        return torch.abs(params["signal_variance"][0]) * factor * K_x

    def diag(self, params, x):
        f = self.features(params, x[:, -1])
        base_sv = self.base.signal_variance(params["base"])
        return torch.abs(params["signal_variance"][0]) * (f * f).sum(-1) * base_sv

    def set_lengthscales(self, params, ls):
        out = dict(params)
        out["base"] = self.base.set_lengthscales(params["base"], ls)
        return out


def _bind_b(gp_params, b):
    """The residual kernels share the global ``b``: a stage's kernel ``b``
    is replaced by it (so the kernel's own leaf gets no gradient)."""
    out = dict(gp_params)
    k = dict(out["kernel"])
    if "b" in k:
        k["b"] = b
    out["kernel"] = k
    return out


class ContinuousAutoRegression:
    """Staged CAR: GPBasic stages, residual kernels `MCFidelityKernel`
    over [i, i+1] on ``kernel_list[i+1]``.  ``if_nonsubset`` trains the
    residuals on the imputed fill data, as AR/NAR/ResGP do."""

    def __init__(self, fidelity_num: int, kernel_list: Sequence[Kernel],
                 b_init: float = 1.0, input_dim: int = 1, if_nonsubset: bool = False,
                 device="cuda"):
        self.device = resolve_device(device)
        self.fidelity_num = fidelity_num
        self.input_dim = input_dim
        self.if_nonsubset = if_nonsubset
        self.gp_list: List[GPBasic] = [GPBasic(kernel=kernel_list[0])] + [
            GPBasic(kernel=MCFidelityKernel(base=kernel_list[i + 1], lf=float(i),
                                            hf=float(i + 1)))
            for i in range(fidelity_num - 1)]
        self.params = {
            "gp": [gp.init_params(input_dim, device=self.device) for gp in self.gp_list],
            "b": torch.tensor(b_init, device=self.device),
        }
        # per-stage residual standardization (shift, scale)
        self.stage_norm = [(0.0, 1.0)] * fidelity_num

    def forward(self, data_manager: MultiFidelityDataManager, x_test,
                to_fidelity: Optional[int] = None,
                denormalize: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """Cascade ``mean = exp(b) mean + shift + scale * m_res``; ``x_test``
        RAW, per-stage x-normalization as in `AR.forward`."""
        level = to_fidelity if to_fidelity is not None else self.fidelity_num - 1
        dev = self.device
        b = self.params["b"]
        rho = torch.exp(b)
        mean = cov = None
        for i in range(level + 1):
            xt_i = stage_x(data_manager, i, x_test, dev)
            if i == 0:
                x_tr, y_tr = data_manager.get_data(0, normal=True)
                mean, cov = self.gp_list[0].predict(
                    self.params["gp"][0], _f32(x_tr, dev), _f32(y_tr, dev), xt_i)
            else:
                x_tr, y_tr = data_manager.get_data_by_name(f"res-{i}")
                y_mean = y_tr[0] if isinstance(y_tr, list) else y_tr
                m_res, c_res = self.gp_list[i].predict(
                    _bind_b(self.params["gp"][i], b), _f32(x_tr, dev), _f32(y_mean, dev),
                    xt_i)
                shift, scale = self.stage_norm[i]
                mean = rho * mean + (shift + scale * m_res)
                cov = rho ** 2 * cov + scale ** 2 * c_res
        if denormalize:
            norm = data_manager.normalizelayer[level]
            mean = mean * float(norm.y_std) + float(norm.y_mean)
            cov = cov * float(norm.y_std) ** 2
        return mean, cov

    __call__ = forward


@dataclasses.dataclass(frozen=True)
class _Car0Loss:
    """Stage-0 NLML."""

    gp: GPBasic

    def __call__(self, p, x, y):
        return self.gp.nll(p, x, y)


@dataclasses.dataclass(frozen=True)
class _CarResLoss:
    """Residual-stage NLML of ``(y_hi - exp(b) y_lo - shift) / scale`` with
    the global ``b`` bound into the fidelity kernel."""

    gp: GPBasic

    def __call__(self, p, sx, yl, yh, shift, scale):
        res = (yh - _lift(torch.exp(p["b"]), yl) * yl - shift) / scale
        return self.gp.nll(_bind_b(p["gp"], p["b"]), sx, res)


@dataclasses.dataclass(frozen=True)
class _CarResVarLoss:
    """Non-subset residual-stage NLML: the imputed targets carry
    variances; ``b`` gets gradients through mean, variance and kernel."""

    gp: GPBasic

    def __call__(self, p, sx, yl_m, yl_v, yh_m, yh_v, shift, scale):
        rho = torch.exp(p["b"])
        res_mean = (yh_m - _lift(rho, yl_m) * yl_m - shift) / scale
        res_var = torch.abs(yh_v - _lift(rho, yl_v) * yl_v) / scale ** 2
        return self.gp.nll(_bind_b(p["gp"], p["b"]), sx, res_mean, y_var=res_var)


def train_CAR(model: ContinuousAutoRegression, data_manager: MultiFidelityDataManager,
              max_iter: int = 100, lr_init: float = 1e-2, n_restarts: int = 4,
              seed: int = 0, debugger=None) -> List[torch.Tensor]:
    """Staged training: stage i >= 1 fits the residual ``y_hi - exp(b)
    y_lo`` on the overlap, with ``b`` shared and trained through every
    residual stage.  An overlap of fewer than 2 rows (or ``if_nonsubset``)
    trains on the imputed fill data instead.  Returns the per-stage loss
    histories, as `train_AR`."""
    dev = model.device
    generator = torch.Generator().manual_seed(seed)
    histories = []
    for i_fid in range(model.fidelity_num):
        gp = model.gp_list[i_fid]
        if i_fid == 0:
            x, y = data_manager.get_data(0, normal=True)
            x, y = _f32(x, dev), _f32(y, dev)
            model.params["gp"][0], hist = _run_stage(
                _Car0Loss(gp), model.params["gp"][0], max_iter, lr_init, n_restarts,
                generator, kernel_spec=gp.kernel, x=x, loss_args=(x, y))
        else:
            use_nonsubset = model.if_nonsubset
            if not use_nonsubset:
                # an empty (None) or one-row overlap cannot fit a residual GP
                ov = data_manager.get_overlap_input_data(i_fid - 1, i_fid, normal=True)
                use_nonsubset = ov[2] is None or int(np.shape(ov[2])[0]) < 2
            if use_nonsubset:
                subset_x, y_low_p, y_high_p = data_manager.get_nonsubset_fill_data(
                    model, i_fid - 1, i_fid)
                yl, yl_v = _f32(y_low_p[0], dev), _f32(y_low_p[1], dev)
                yh, yh_v = _f32(y_high_p[0], dev), _f32(y_high_p[1], dev)
            else:
                _, y_low, subset_x, y_high = data_manager.get_overlap_input_data(
                    i_fid - 1, i_fid, normal=True)
                yl, yh, yl_v = _f32(y_low, dev), _f32(y_high, dev), None
            sx = _f32(subset_x, dev)
            shift, scale = _residual_norm(yh - torch.exp(model.params["b"]) * yl)
            model.stage_norm[i_fid] = (shift, scale)
            if yl_v is None:
                loss_i, loss_args_i = _CarResLoss(gp), (sx, yl, yh, shift, scale)
            else:
                loss_i = _CarResVarLoss(gp)
                loss_args_i = (sx, yl, yl_v, yh, yh_v, shift, scale)
            stage_p, hist = _run_stage(
                loss_i, {"gp": model.params["gp"][i_fid], "b": model.params["b"]},
                max_iter, lr_init, n_restarts, generator, kernel_spec=gp.kernel, x=sx,
                gp_field="gp", loss_args=loss_args_i)
            model.params["gp"][i_fid] = stage_p["gp"]
            model.params["b"] = stage_p["b"]
            with torch.no_grad():
                res_final = (yh - torch.exp(stage_p["b"]) * yl - shift) / scale
            data_manager.add_data(raw_fidelity_name=f"res-{i_fid}", fidelity_index=None,
                                  x=sx.cpu().numpy(), y=[res_final.cpu().numpy(), None])
        histories.append(hist)
        if debugger is not None:
            debugger.record_stage(i_fid, hist)
    return histories


class ContinuousAutoRegressionLarge:
    """Joint CAR: one GPBasic over ``[x, s]`` trained on all fidelities at
    once, with a relative nugget (1e-4 mean diag K): the stacked rows
    repeat x at different s, so the joint Gram is close to singular."""

    def __init__(self, fidelity_num: int, kernel_x: Kernel, b_init: float = 1.0,
                 input_dim: int = 1, device="cuda"):
        self.device = resolve_device(device)
        self.fidelity_num = fidelity_num
        self.input_dim = input_dim
        self.gp = GPBasic(kernel=ContinuousFidelityKernel(base=kernel_x), jitter=1e-4,
                          relative_jitter=True)
        self.params = self.gp.init_params(input_dim, device=self.device)
        self.params["kernel"]["b"] = torch.tensor(b_init, device=self.device)

    def joint_train_data(self, data_manager) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every fidelity's normalized (x, y), x with its column s = i + 1,
        stacked."""
        xs, ys = [], []
        for i in range(self.fidelity_num):
            x, y = data_manager.get_data(i, normal=True)
            xs.append(np.concatenate([np.asarray(x), np.full((len(x), 1), i + 1.0)], axis=1))
            ys.append(np.asarray(y))
        return _f32(np.concatenate(xs), self.device), _f32(np.concatenate(ys), self.device)

    def forward(self, data_manager: MultiFidelityDataManager, x_test,
                to_fidelity: Optional[int] = None,
                denormalize: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """``x_test`` RAW, normalized with the target fidelity's x-stats."""
        x_tr, y_tr = self.joint_train_data(data_manager)
        level = to_fidelity if to_fidelity is not None else self.fidelity_num - 1
        norm = data_manager.normalizelayer[level]
        xt_n = _f32(norm.normalize_x(np.asarray(x_test)), self.device)
        s = torch.full((xt_n.shape[0], 1), float(level + 1), device=self.device)
        mean, cov = self.gp.predict(self.params, x_tr, y_tr, torch.cat([xt_n, s], dim=1))
        if denormalize:
            mean = mean * float(norm.y_std) + float(norm.y_mean)
            cov = cov * float(norm.y_std) ** 2
        return mean, cov

    __call__ = forward


def train_CAR_large(model: ContinuousAutoRegressionLarge,
                    data_manager: MultiFidelityDataManager, max_iter: int = 100,
                    lr_init: float = 1e-2) -> torch.Tensor:
    """One joint NLML over the stacked multi-fidelity dataset, unbatched
    (K1 + K2 + K3b a step).  Returns the ``(max_iter,)`` loss history."""
    x_tr, y_tr = model.joint_train_data(data_manager)
    result = fit(model.gp.nll, model.params, steps=max_iter, lr=lr_init,
                 loss_args=(x_tr, y_tr))
    model.params = result.params
    return result.losses
