"""NAR: nonlinear autoregressive multi-fidelity GP.

Port of `fidelityfusion_tpu/models/nar.py`: fidelity i's GP takes the
input ``[x, y_{i-1}(x)]``, a nonlinear coupling learned by the kernel,
with no rho.  Prediction feeds
the predicted lower-fidelity mean in as the next stage's last input
column, so stages i >= 1 run K1 at d = input_dim + 1.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from fidelityfusion_tpu_torch.models.ar import (
    _run_cigp_stage,
    _f32,
    pad_with_mask,
    stage_x,
)
from fidelityfusion_tpu_torch.models.cigp import CIGP
from fidelityfusion_tpu_torch.models.data_manager import MultiFidelityDataManager
from fidelityfusion_tpu_torch.ops.kernels import Kernel
from fidelityfusion_tpu_torch.utils.device import resolve_device


class NAR:
    """Nonlinear autoregressive multi-fidelity model: a CIGP per fidelity
    on ``[x, y_low]``."""

    def __init__(self, fidelity_num: int, kernel_list: Sequence[Kernel],
                 if_nonsubset: bool = False, input_dim: int = 1, device="cuda"):
        self.device = resolve_device(device)
        self.fidelity_num = fidelity_num
        self.gp_list: List[CIGP] = [CIGP(kernel=k) for k in kernel_list]
        self.if_nonsubset = if_nonsubset
        self.input_dim = input_dim
        # stage i > 0 sees [x, y_low]: input_dim + 1 columns
        self.params = {"gp": [
            gp.init_params(input_dim if i == 0 else input_dim + 1, device=self.device)
            for i, gp in enumerate(self.gp_list)]}

    def forward(self, data_manager: MultiFidelityDataManager, x_test,
                to_fidelity: Optional[int] = None,
                denormalize: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """Cascade: stage i's GP at ``[x (stage-i space), predicted y_low
        (fidelity i-1 normalized y)]``, the space of its ``concat-i``
        training set.  ``x_test`` is RAW.  Each stage's covariance replaces
        the one below it."""
        level = to_fidelity if to_fidelity is not None else self.fidelity_num - 1
        dev = self.device
        mean = cov = None
        for i in range(level + 1):
            xt_i = stage_x(data_manager, i, x_test, dev)
            if i == 0:
                x_tr, y_tr = data_manager.get_data(0, normal=True)
            else:
                x_tr, y_tr = data_manager.get_data_by_name(f"concat-{i}")
                y_tr = y_tr[0] if isinstance(y_tr, list) else y_tr
                xt_i = torch.cat([xt_i, mean.reshape(xt_i.shape[0], -1)], dim=-1)
            mean, cov = self.gp_list[i].predict(
                self.params["gp"][i], _f32(x_tr, dev), _f32(y_tr, dev), xt_i)
        if denormalize:
            norm = data_manager.normalizelayer[level]
            mean = mean * float(norm.y_std) + float(norm.y_mean)
            cov = cov * float(norm.y_std) ** 2
        return mean, cov

    __call__ = forward

    def export_posterior(self, data_manager: MultiFidelityDataManager,
                         to_fidelity: Optional[int] = None, diag: bool = True,
                         pad_multiple: Optional[int] = None):
        """(NARPosterior, state): the cascade with every stage's
        factorization done once (`CIGP.posterior_cache`).  Call `train_NAR`
        first: stage data lives under ``concat-{i}``."""
        level = to_fidelity if to_fidelity is not None else self.fidelity_num - 1
        dev = self.device
        one, zero = torch.tensor(1.0, device=dev), torch.tensor(0.0, device=dev)
        stages = []
        with torch.no_grad():
            for i in range(level + 1):
                norm = data_manager.normalizelayer.get(i)
                x_mean = _f32(norm.x_mean, dev) if norm is not None else zero
                x_std = _f32(norm.x_std, dev) + 1e-10 if norm is not None else one
                if i == 0:
                    x_tr, y_use = data_manager.get_data(0, normal=True)
                else:
                    x_tr, y_tr = data_manager.get_data_by_name(f"concat-{i}")
                    y_use = y_tr[0] if isinstance(y_tr, list) else y_tr
                if pad_multiple:
                    x_p, y_p, mask = pad_with_mask(x_tr, y_use, pad_multiple, dev)
                else:
                    x_p, y_p, mask = _f32(x_tr, dev), _f32(y_use, dev), None
                cache = self.gp_list[i].posterior_cache(self.params["gp"][i], x_p, y_p,
                                                        mask=mask)
                stages.append({"x": x_p, "cache": cache, "mask": mask,
                               "gp": self.params["gp"][i],
                               "x_mean": x_mean, "x_std": x_std})
        norm = data_manager.normalizelayer[level]
        state = {"stages": stages,
                 "y_norm": (torch.tensor(float(norm.y_mean), device=dev),
                            torch.tensor(float(norm.y_std), device=dev))}
        return NARPosterior(tuple(self.gp_list), level, diag), state


@dataclasses.dataclass(frozen=True)
class NARPosterior:
    """`NAR.forward` as a callable over a ``state`` dict (see
    `NAR.export_posterior`): stage i >= 1 evaluates its GP at
    ``[normalize_i(x), mean_{i-1}]``, and only the last stage's variance
    is reported.  ``diag`` selects diagonal variances."""

    gps: tuple
    to_fidelity: int
    diag: bool = True

    def __call__(self, state, x_raw):
        x_raw = _f32(x_raw, state["stages"][0]["x"].device)
        mean = var = None
        for i in range(self.to_fidelity + 1):
            st = state["stages"][i]
            xt = (x_raw - st["x_mean"]) / st["x_std"]
            if i > 0:
                xt = torch.cat([xt, mean.reshape(xt.shape[0], -1)], dim=-1)
            predict = (self.gps[i].predict_diag_cached if self.diag
                       else self.gps[i].predict_cached)
            mean, var = predict(st["gp"], st["cache"], st["x"], xt, mask=st["mask"])
        y_mean, y_std = state["y_norm"]
        return mean * y_std + y_mean, var * y_std ** 2


def train_NAR(model: NAR, data_manager: MultiFidelityDataManager,
              max_iter: int = 100, lr_init: float = 1e-2, n_restarts: int = 4,
              seed: int = 0, debugger=None, n_mesh=None,
              nshard_min_rows: int = 2048) -> List[torch.Tensor]:
    """Sequential training: stage i >= 1 fits a GP from ``[subset_x,
    y_low]`` to ``y_high`` (non-subset: the imputed ``y_low`` and
    ``y_high``'s variance as ``y_var``) and registers that training set as
    ``concat-i`` for the cascade.  Returns the per-stage loss histories,
    as `train_AR`.

    ``n_mesh``: stages of at least ``nshard_min_rows`` rows train through
    the n-axis sharded factorization (`models/ar.py:train_AR`); NAR's
    stage inputs and targets are built before a stage trains, so every
    stage can go."""
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
                y_low, y, y_var = y_low_p[0], _f32(y_high_p[0], dev), _f32(y_high_p[1], dev)
            else:
                _, y_low, subset_x, y_high = data_manager.get_overlap_input_data(
                    i_fid - 1, i_fid, normal=True)
                y, y_var = _f32(y_high, dev), None
            x = torch.cat([_f32(subset_x, dev),
                           _f32(y_low, dev).reshape(len(subset_x), -1)], dim=-1)
            data_manager.add_data(
                raw_fidelity_name=f"concat-{i_fid}", fidelity_index=None,
                x=x.cpu().numpy(),
                y=[y.cpu().numpy(), None if y_var is None else y_var.cpu().numpy()])
        model.params["gp"][i_fid], hist = _run_cigp_stage(
            gp, model.params["gp"][i_fid], x, y, y_var, max_iter, lr_init, n_restarts,
            generator, n_mesh, nshard_min_rows)
        histories.append(hist)
        if debugger is not None:
            debugger.record_stage(i_fid, hist)
    return histories
