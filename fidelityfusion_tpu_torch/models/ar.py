"""AR (Kennedy-O'Hagan autoregressive) multi-fidelity fusion.

Port of `fidelityfusion_tpu/models/ar.py`:

    y_hi(x) = rho_i * y_lo(x) + res_i(x)

with a CIGP residual GP per fidelity and a trainable scalar rho per step.
Training is staged: each fidelity's (GP hyperparameters, rho) is fitted by
Adam over a batch of restarts (the deterministic length-scale ladder),
with residual targets recomputed inside the loss so rho gets gradients
through them.  Non-subset data impute missing low-fidelity observations
with the model's own cascade between stages.  With ``n_mesh``, stages of
at least ``nshard_min_rows`` rows train through the n-axis sharded
factorization (`parallel/nsharded.py`, `_run_stage_nsharded`).

The model holds static specs, a parameter dict of tensors on
``model.device`` and the per-stage residual standardization.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from fidelityfusion_tpu_torch.models.cigp import CIGP
from fidelityfusion_tpu_torch.models.data_manager import MultiFidelityDataManager
from fidelityfusion_tpu_torch.ops import linalg
from fidelityfusion_tpu_torch.ops.kernels import Kernel
from fidelityfusion_tpu_torch.train.fit import (
    fit,
    fit_restarts,
    gp_restart_batch,
    perturb_params,
    stack_params,
)
from fidelityfusion_tpu_torch.utils.device import resolve_device
from fidelityfusion_tpu_torch.utils.tree import tree_map


def _f32(a, device) -> torch.Tensor:
    if torch.is_tensor(a):
        return a.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(a, np.float32), device=device)


def _lift(s, ref):
    """A (*batch) tensor shaped to broadcast against a (*batch?, ...) one."""
    return s.reshape(s.shape + (1,) * ref.ndim)


def stage_x(data_manager, i: int, x_raw, device) -> torch.Tensor:
    """Normalize raw inputs with stage i's x-statistics (pass-through
    without a normalizer)."""
    x = _f32(x_raw, device)
    norm = data_manager.normalizelayer.get(i)
    if norm is None:
        return x
    return (x - _f32(norm.x_mean, device)) / (_f32(norm.x_std, device) + 1e-10)


class AR:
    """Autoregressive multi-fidelity model (Kennedy & O'Hagan)."""

    def __init__(self, fidelity_num: int, kernel_list: Sequence[Kernel],
                 rho_init: float = 1.0, if_nonsubset: bool = False,
                 input_dim: int = 1, device="cuda"):
        self.device = resolve_device(device)
        self.fidelity_num = fidelity_num
        self.gp_list: List[CIGP] = [CIGP(kernel=k) for k in kernel_list]
        self.if_nonsubset = if_nonsubset
        self.input_dim = input_dim
        self.params = {
            "gp": [gp.init_params(input_dim, device=self.device) for gp in self.gp_list],
            "rho": [torch.tensor(rho_init, device=self.device)
                    for _ in range(fidelity_num - 1)],
        }
        # per-stage residual standardization (shift, scale)
        self.stage_norm = [(0.0, 1.0)] * fidelity_num

    def export_posterior(self, data_manager: MultiFidelityDataManager,
                         to_fidelity: Optional[int] = None, diag: bool = True,
                         pad_multiple: Optional[int] = None):
        """(ARPosterior, state): the cascade with every stage's
        factorization done once (`CIGP.posterior_cache`)."""
        return _export_cascade(self, data_manager, to_fidelity, diag, pad_multiple)

    def forward(self, data_manager: MultiFidelityDataManager, x_test,
                to_fidelity: Optional[int] = None,
                denormalize: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """Prediction cascade: the fidelity-0 posterior plus rho-scaled
        residual posteriors.  ``x_test`` is RAW; each stage normalizes it
        with its own x-statistics.  Returns (mean, full covariance), in raw
        y units when ``denormalize``."""
        level = to_fidelity if to_fidelity is not None else self.fidelity_num - 1
        dev = self.device
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
                    self.params["gp"][i], _f32(x_tr, dev), _f32(y_mean, dev), xt_i)
                # consistent recombination: training fits res = y_hi - rho*y_lo
                rho = self.params["rho"][i - 1]
                shift, scale = self.stage_norm[i]
                mean = rho * mean + (shift + scale * m_res)
                cov = rho ** 2 * cov + scale ** 2 * c_res
        if denormalize:
            norm = data_manager.normalizelayer[level]
            mean = mean * float(norm.y_std) + float(norm.y_mean)
            cov = cov * float(norm.y_std) ** 2
        return mean, cov

    __call__ = forward


def train_AR(model: AR, data_manager: MultiFidelityDataManager,
             max_iter: int = 100, lr_init: float = 1e-2, n_restarts: int = 4,
             seed: int = 0, debugger=None,
             pad_multiple: Optional[int] = None, n_mesh=None,
             nshard_min_rows: int = 2048) -> List[torch.Tensor]:
    """Sequential per-fidelity training.  Stage 0 fits the base GP on
    fidelity-0 data; stage i >= 1 fits the residual GP on
    ``y_hi - rho_i * y_lo`` over the subset (or the imputed non-subset fill
    data with variance targets).  Returns the per-stage loss histories,
    ``(n_restarts, max_iter)`` each (``(max_iter,)`` without restarts).

    ``n_mesh``: a `DeviceMesh` with an ``"n"`` dim (and optionally ``"r"``,
    `parallel/nsharded.py:make_rn_mesh`), every rank calling this with the
    same model and data.  Stages of at least ``nshard_min_rows`` rows then
    train through `fit_restarts_nsharded` (the restart ladder on "r", the
    Gram and factor rows on "n"), and return their per-restart final NLMLs
    for a history.  Masked or padded stages and imputed-variance
    non-subset stages (whose variance target depends on rho) stay
    unsharded, as in the JAX package."""
    dev = model.device
    generator = torch.Generator().manual_seed(seed)
    histories = []
    for i_fid in range(model.fidelity_num):
        gp = model.gp_list[i_fid]
        if i_fid == 0:
            x_low, y_low = data_manager.get_data(0, normal=True)
            if pad_multiple:
                x_low, y_low, mask0 = pad_with_mask(x_low, y_low, pad_multiple, dev)
            else:
                x_low, y_low, mask0 = _f32(x_low, dev), _f32(y_low, dev), None
            if n_mesh is not None and mask0 is None and x_low.shape[0] >= nshard_min_rows:
                stage_params, hist = _run_stage_nsharded(
                    gp, model.params["gp"][0], x_low, y_low, None, n_mesh, max_iter, lr_init,
                    n_restarts, generator)
            else:
                stage_params, hist = _run_stage(
                    _CigpNLL(gp), model.params["gp"][0], max_iter, lr_init,
                    n_restarts, generator, kernel_spec=gp.kernel, x=x_low,
                    loss_args=(x_low, y_low, None, mask0))
            model.params["gp"][0] = stage_params
        else:
            rho0 = model.params["rho"][i_fid - 1]
            if model.if_nonsubset:
                subset_x, y_low_p, y_high_p = data_manager.get_nonsubset_fill_data(
                    model, i_fid - 1, i_fid)
                sx = _f32(subset_x, dev)
                yl_m, yl_v = _f32(y_low_p[0], dev), _f32(y_low_p[1], dev)
                yh_m, yh_v = _f32(y_high_p[0], dev), _f32(y_high_p[1], dev)
                shift, scale = _residual_norm(yh_m - rho0 * yl_m)
                model.stage_norm[i_fid] = (shift, scale)
                mask_i = None
                if pad_multiple:
                    sx_t, yl_m_t, mask_i = pad_with_mask(sx, yl_m, pad_multiple, dev)
                    _, yl_v_t, _ = pad_with_mask(sx, yl_v, pad_multiple, dev)
                    _, yh_m_t, _ = pad_with_mask(sx, yh_m, pad_multiple, dev)
                    _, yh_v_t, _ = pad_with_mask(sx, yh_v, pad_multiple, dev)
                else:
                    sx_t, yl_m_t, yl_v_t, yh_m_t, yh_v_t = sx, yl_m, yl_v, yh_m, yh_v
                loss_i = _ResidualVarLoss(gp)
                loss_args_i = (sx_t, yl_m_t, yl_v_t, yh_m_t, yh_v_t, shift, scale, mask_i)
            else:
                _, y_low, subset_x, y_high = data_manager.get_overlap_input_data(
                    i_fid - 1, i_fid, normal=True)
                if pad_multiple:
                    sx, yl, mask_i = pad_with_mask(subset_x, y_low, pad_multiple, dev)
                    _, yh, _ = pad_with_mask(subset_x, y_high, pad_multiple, dev)
                else:
                    sx, yl, yh = _f32(subset_x, dev), _f32(y_low, dev), _f32(y_high, dev)
                    mask_i = None
                shift, scale = _residual_norm(_f32(y_high, dev) - rho0 * _f32(y_low, dev))
                model.stage_norm[i_fid] = (shift, scale)
                loss_i = _ResidualLoss(gp)
                loss_args_i = (sx, yl, yh, shift, scale, mask_i)

            stage_p = {"gp": model.params["gp"][i_fid], "rho": rho0}
            if (n_mesh is not None and not model.if_nonsubset and not pad_multiple
                    and sx.shape[0] >= nshard_min_rows):
                stage_params, hist = _run_stage_nsharded(
                    gp, stage_p, sx, None, (yl, yh, shift, scale), n_mesh, max_iter,
                    lr_init, n_restarts, generator, gp_field="gp")
            else:
                stage_params, hist = _run_stage(
                    loss_i, stage_p, max_iter, lr_init, n_restarts, generator,
                    kernel_spec=gp.kernel, x=sx, gp_field="gp", loss_args=loss_args_i)
            model.params["gp"][i_fid] = stage_params["gp"]
            model.params["rho"][i_fid - 1] = stage_params["rho"]

            # register the standardized residual dataset for the cascade
            rho = stage_params["rho"]
            shift, scale = model.stage_norm[i_fid]
            with torch.no_grad():
                if model.if_nonsubset:
                    res_mean = ((yh_m - rho * yl_m - shift) / scale).cpu().numpy()
                    res_var = (torch.abs(yh_v - rho * yl_v) / scale ** 2).cpu().numpy()
                    data_manager.add_data(raw_fidelity_name=f"res-{i_fid}",
                                          fidelity_index=None, x=sx.cpu().numpy(),
                                          y=[res_mean, res_var])
                else:
                    res_mean = ((yh - rho * yl - shift) / scale).cpu().numpy()
                    sx_store = sx.cpu().numpy()
                    if pad_multiple:
                        # padded zero-rows never enter the cascade as data
                        n_live = int(mask_i.sum())
                        sx_store, res_mean = sx_store[:n_live], res_mean[:n_live]
                    data_manager.add_data(raw_fidelity_name=f"res-{i_fid}",
                                          fidelity_index=None, x=sx_store,
                                          y=[res_mean, None])
        histories.append(hist)
        if debugger is not None:
            debugger.record_stage(i_fid, hist)
    return histories


def _export_cascade(model, data_manager, to_fidelity=None, diag=True,
                    pad_multiple=None):
    """Export for rho-residual cascades (models without "rho" get rho=1)."""
    level = to_fidelity if to_fidelity is not None else model.fidelity_num - 1
    dev = model.device
    one, zero = torch.tensor(1.0, device=dev), torch.tensor(0.0, device=dev)
    stages = []
    with torch.no_grad():
        for i in range(level + 1):
            norm = data_manager.normalizelayer.get(i)
            x_mean = _f32(norm.x_mean, dev) if norm is not None else zero
            x_std = _f32(norm.x_std, dev) + 1e-10 if norm is not None else one
            if i == 0:
                x_tr, y_use = data_manager.get_data(0, normal=True)
                rho, shift, scale = one, zero, one
            else:
                x_tr, y_tr = data_manager.get_data_by_name(f"res-{i}")
                y_use = y_tr[0] if isinstance(y_tr, list) else y_tr
                rho = (_f32(model.params["rho"][i - 1], dev)
                       if "rho" in model.params else one)
                s_, c_ = model.stage_norm[i]
                shift, scale = torch.tensor(float(s_), device=dev), torch.tensor(float(c_), device=dev)
            if pad_multiple:
                x_p, y_p, mask = pad_with_mask(x_tr, y_use, pad_multiple, dev)
            else:
                x_p, y_p, mask = _f32(x_tr, dev), _f32(y_use, dev), None
            cache = model.gp_list[i].posterior_cache(model.params["gp"][i], x_p, y_p, mask=mask)
            stages.append({"x": x_p, "cache": cache, "mask": mask,
                           "gp": model.params["gp"][i], "rho": rho,
                           "shift": shift, "scale": scale,
                           "x_mean": x_mean, "x_std": x_std})
    norm = data_manager.normalizelayer[level]
    state = {"stages": stages,
             "y_norm": (torch.tensor(float(norm.y_mean), device=dev),
                        torch.tensor(float(norm.y_std), device=dev))}
    return ARPosterior(tuple(model.gp_list), level, diag), state


@dataclasses.dataclass(frozen=True)
class ARPosterior:
    """The AR cascade as a callable over a ``state`` dict (see
    `AR.export_posterior`): raw x in, raw y out, each stage's factorization
    precomputed so a call is cross-Grams plus GEMMs.  ``diag`` selects
    diagonal variances instead of the full covariance."""

    gps: tuple
    to_fidelity: int
    diag: bool = True

    def __call__(self, state, x_raw):
        x_raw = _f32(x_raw, state["stages"][0]["x"].device)
        mean = var = None
        for i in range(self.to_fidelity + 1):
            st = state["stages"][i]
            xt = (x_raw - st["x_mean"]) / st["x_std"]
            predict = (self.gps[i].predict_diag_cached if self.diag
                       else self.gps[i].predict_cached)
            m, v = predict(st["gp"], st["cache"], st["x"], xt, mask=st["mask"])
            if i == 0:
                mean, var = m, v
            else:
                rho, shift, scale = st["rho"], st["shift"], st["scale"]
                mean = rho * mean + (shift + scale * m)
                var = rho ** 2 * var + scale ** 2 * v
        y_mean, y_std = state["y_norm"]
        return mean * y_std + y_mean, var * y_std ** 2


@dataclasses.dataclass(frozen=True)
class _ResidualLoss:
    """Subset-mode stage loss: NLML of ``(y_hi - rho*y_lo - shift)/scale``."""

    gp: CIGP

    def __call__(self, p, sx, yl, yh, shift, scale, mask):
        res_mean = (yh - _lift(p["rho"], yl) * yl - shift) / scale
        return self.gp.nll(p["gp"], sx, res_mean, mask=mask)


@dataclasses.dataclass(frozen=True)
class _ResidualVarLoss:
    """Non-subset stage loss: imputed targets carry variances; rho gets
    gradients through both."""

    gp: CIGP

    def __call__(self, p, sx, yl_m, yl_v, yh_m, yh_v, shift, scale, mask=None):
        rho = p["rho"]
        res_mean = (yh_m - _lift(rho, yl_m) * yl_m - shift) / scale
        res_var = torch.abs(yh_v - _lift(rho, yl_v) * yl_v) / scale ** 2
        return self.gp.nll(p["gp"], sx, res_mean, y_var=res_var, mask=mask)


@dataclasses.dataclass(frozen=True)
class _CigpNLL:
    """`CIGP.nll` as a callable carrying its spec."""

    gp: CIGP

    def __call__(self, p, x, y, y_var=None, mask=None):
        return self.gp.nll(p, x, y, y_var=y_var, mask=mask)


def _run_stage(loss_fn, params, steps, lr, n_restarts, generator,
               kernel_spec=None, x=None, gp_field=None, loss_args=None, aux0=None):
    """One stage's Adam fit; with restarts, over the deterministic
    length-scale ladder applied to the GP subtree (``params[gp_field]`` or
    ``params``), else random jitter from ``generator``.

    ``aux0``: one (unbatched) aux carry for an aux-threading loss (the HOGP
    tracked eigenbasis), broadcast over the restarts here."""
    if n_restarts <= 1:
        result = fit(loss_fn, params, steps=steps, lr=lr, loss_args=loss_args, aux0=aux0)
        return result.params, result.losses
    if kernel_spec is not None and x is not None:
        gp_params = params[gp_field] if gp_field else params
        gp_inits = gp_restart_batch(kernel_spec, gp_params, x, n_restarts, generator)
        inits = [{**params, gp_field: g} for g in gp_inits] if gp_field else gp_inits
        batch = stack_params(inits)
    else:
        batch = perturb_params(generator, params, n=n_restarts)
    aux_batch = None if aux0 is None else tree_map(
        lambda a: a.expand((n_restarts,) + a.shape), aux0)
    best, result = fit_restarts(loss_fn, batch, steps=steps, lr=lr, loss_args=loss_args,
                                aux0=aux_batch)
    return best, result.losses


def _run_stage_nsharded(gp, params, x, y, residual, mesh, steps, lr, n_restarts, generator,
                        gp_field=None, y_var=None, lift=None):
    """One stage through `parallel/nsharded.py:fit_restarts_nsharded`:
    the same deterministic length-scale ladder as `_run_stage`, the
    restarts on the mesh's ``"r"`` dim when it has one that divides R, the
    Gram and factor rows on ``"n"``.  Returns ``(best_params,
    per_restart_final_losses)``."""
    from fidelityfusion_tpu_torch.parallel.mesh import axis_size
    from fidelityfusion_tpu_torch.parallel.nsharded import fit_restarts_nsharded

    n_restarts = max(1, n_restarts)
    gp_params = params[gp_field] if gp_field else params
    gp_inits = gp_restart_batch(gp.kernel, gp_params, x, n_restarts, generator)
    batch = stack_params([{**params, gp_field: g} for g in gp_inits] if gp_field else gp_inits)
    r_axis = None
    if "r" in mesh.mesh_dim_names and n_restarts % axis_size(mesh, "r") == 0:
        r_axis = "r"
    return fit_restarts_nsharded(gp, batch, x, y, mesh, steps=steps, lr=lr, r_axis=r_axis,
                                 residual=residual, y_var=y_var, lift=lift)


def _run_cigp_stage(gp, params, x, y, y_var, steps, lr, n_restarts, generator, n_mesh,
                    nshard_min_rows):
    """A stage whose targets are known before it trains (ResGP, NAR): the
    CIGP NLML of ``(x, y, y_var)``, n-sharded from ``nshard_min_rows`` rows
    when ``n_mesh`` is given, else `_run_stage`."""
    if n_mesh is not None and x.shape[0] >= nshard_min_rows:
        return _run_stage_nsharded(gp, params, x, y, None, n_mesh, steps, lr, n_restarts,
                                   generator, y_var=y_var)
    return _run_stage(_CigpNLL(gp), params, steps, lr, n_restarts, generator,
                      kernel_spec=gp.kernel, x=x, loss_args=(x, y, y_var))


def pad_with_mask(x, y, pad_multiple: int, device):
    """(x, y) padded to the next multiple of ``pad_multiple`` rows, plus the
    live-row mask; the masked NLML equals the unpadded one."""
    n = x.shape[0]
    n_pad = int(math.ceil(n / pad_multiple) * pad_multiple)
    return (linalg.pad_rows(_f32(x, device), n_pad),
            linalg.pad_rows(_f32(y, device), n_pad),
            linalg.row_mask(n, n_pad, device=device))


def _residual_norm(res) -> tuple:
    """(shift, scale) of a stage's residual targets (std with ddof 0), scale
    floored so a zero residual keeps identity scaling."""
    shift = float(torch.mean(res))
    scale = float(torch.std(res, correction=0))
    if not np.isfinite(scale) or scale < 1e-8:
        shift, scale = 0.0, 1.0
    return shift, scale
