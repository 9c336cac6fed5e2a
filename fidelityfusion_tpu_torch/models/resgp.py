"""ResGP: residual multi-fidelity GP (rho fixed at 1).

Port of `fidelityfusion_tpu/models/resgp.py`:

    y_hi(x) = y_lo(x) + res_i(x)

Training and prediction are AR's (`models/ar.py`) with rho == 1 and no
coupling parameter, so every stage's targets are known before it trains.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from fidelityfusion_tpu_torch.models.ar import (
    _run_cigp_stage,
    _export_cascade,
    _f32,
    _residual_norm,
    stage_x,
)
from fidelityfusion_tpu_torch.models.cigp import CIGP
from fidelityfusion_tpu_torch.models.data_manager import MultiFidelityDataManager
from fidelityfusion_tpu_torch.ops.kernels import Kernel
from fidelityfusion_tpu_torch.utils.device import resolve_device


class ResGP:
    """Residual multi-fidelity model: a CIGP per fidelity on the residual
    to the cascade below it."""

    def __init__(self, fidelity_num: int, kernel_list: Sequence[Kernel],
                 if_nonsubset: bool = False, input_dim: int = 1, device="cuda"):
        self.device = resolve_device(device)
        self.fidelity_num = fidelity_num
        self.gp_list: List[CIGP] = [CIGP(kernel=k) for k in kernel_list]
        self.if_nonsubset = if_nonsubset
        self.input_dim = input_dim
        self.params = {"gp": [gp.init_params(input_dim, device=self.device)
                              for gp in self.gp_list]}
        # per-stage residual standardization (shift, scale)
        self.stage_norm = [(0.0, 1.0)] * fidelity_num

    def export_posterior(self, data_manager: MultiFidelityDataManager,
                         to_fidelity: Optional[int] = None, diag: bool = True,
                         pad_multiple: Optional[int] = None):
        """(ARPosterior, state) with rho = 1: see `AR.export_posterior`."""
        return _export_cascade(self, data_manager, to_fidelity, diag, pad_multiple)

    def forward(self, data_manager: MultiFidelityDataManager, x_test,
                to_fidelity: Optional[int] = None,
                denormalize: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """The fidelity-0 posterior plus the residual posteriors; ``x_test``
        RAW, per-stage x-normalization as in `AR.forward`."""
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
                shift, scale = self.stage_norm[i]
                mean = mean + (shift + scale * m_res)
                cov = cov + scale ** 2 * c_res
        if denormalize:
            norm = data_manager.normalizelayer[level]
            mean = mean * float(norm.y_std) + float(norm.y_mean)
            cov = cov * float(norm.y_std) ** 2
        return mean, cov

    __call__ = forward


def train_ResGP(model: ResGP, data_manager: MultiFidelityDataManager,
                max_iter: int = 100, lr_init: float = 1e-2, n_restarts: int = 4,
                seed: int = 0, debugger=None, n_mesh=None,
                nshard_min_rows: int = 2048) -> List[torch.Tensor]:
    """Sequential per-fidelity training: stage i >= 1 fits the standardized
    residual ``y_hi - y_lo`` on the overlap (subset) or on the imputed
    mean, with variance ``|var_hi - var_lo|`` (non-subset).  Returns the
    per-stage loss histories, as `train_AR`.

    ``n_mesh``: stages of at least ``nshard_min_rows`` rows train through
    the n-axis sharded factorization (`models/ar.py:train_AR`); ResGP's
    targets are known before a stage trains (rho is 1), so every stage,
    the imputed-variance non-subset ones included (``y_var`` on the
    sharded diagonal), can go."""
    dev = model.device
    generator = torch.Generator().manual_seed(seed)
    histories = []
    for i_fid in range(model.fidelity_num):
        gp = model.gp_list[i_fid]
        if i_fid == 0:
            x, y = data_manager.get_data(0, normal=True)
            x, y, y_var = _f32(x, dev), _f32(y, dev), None
        else:
            if model.if_nonsubset:
                subset_x, y_low_p, y_high_p = data_manager.get_nonsubset_fill_data(
                    model, i_fid - 1, i_fid)
                res_raw = _f32(y_high_p[0] - y_low_p[0], dev)
                res_var = _f32(y_high_p[1] - y_low_p[1], dev)
            else:
                _, y_low, subset_x, y_high = data_manager.get_overlap_input_data(
                    i_fid - 1, i_fid, normal=True)
                res_raw, res_var = _f32(y_high - y_low, dev), None
            x = _f32(subset_x, dev)
            shift, scale = _residual_norm(res_raw)
            model.stage_norm[i_fid] = (shift, scale)
            y = (res_raw - shift) / scale
            y_var = None if res_var is None else torch.abs(res_var) / scale ** 2
            data_manager.add_data(
                raw_fidelity_name=f"res-{i_fid}", fidelity_index=None,
                x=x.cpu().numpy(),
                y=[y.cpu().numpy(), None if y_var is None else y_var.cpu().numpy()])
        model.params["gp"][i_fid], hist = _run_cigp_stage(
            gp, model.params["gp"][i_fid], x, y, y_var, max_iter, lr_init, n_restarts,
            generator, n_mesh, nshard_min_rows)
        histories.append(hist)
        if debugger is not None:
            debugger.record_stage(i_fid, hist)
    return histories

