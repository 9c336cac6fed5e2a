"""CIGAR: conditionally-independent GAR.

Port of `fidelityfusion_tpu/models/cigar.py`: GAR's cascade with each
fidelity's tensor output flattened to ``(n, D)`` and one shared-kernel
CIGP per fidelity in place of a HOGP; the variance is the per-row
diagonal broadcast over the output columns.

    Y_hi(x) = TL_i(Y_lo(x)) + Res_i(x)       (outputs flattened to (n, D))

Restart stages of at least 320 rows train through the batched GEMM-only
NLML (`models/ar.py:_blocked_variant`: K1 + K3a + K3b), the winner's
re-check and the predictions through K2.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from fidelityfusion_tpu_torch.models.ar import (
    _f32, _residual_norm, _run_stage, _run_stage_nsharded, stage_x)
from fidelityfusion_tpu_torch.models.cigp import CIGP
from fidelityfusion_tpu_torch.models.coupling import TensorLinear
from fidelityfusion_tpu_torch.models.data_manager import MultiFidelityDataManager
from fidelityfusion_tpu_torch.ops.kernels import Kernel
from fidelityfusion_tpu_torch.utils.device import resolve_device


def _apply_tl_flat(tl: TensorLinear, params_tl, y_flat: torch.Tensor) -> torch.Tensor:
    """The lift on a flattened ``(..., n, D_low)`` batch: ``(..., n, D_high)``."""
    y = y_flat.reshape(y_flat.shape[:-1] + tuple(tl.l_shape))
    out = tl.apply(params_tl, y)
    return out.reshape(out.shape[:out.ndim - len(tl.h_shape)] + (-1,))


@dataclasses.dataclass(frozen=True)
class _Cigar0Loss:
    """Stage-0 CIGP NLML."""

    gp: CIGP

    def __call__(self, p, x, y):
        return self.gp.nll(p["gp"], x, y)


@dataclasses.dataclass(frozen=True)
class _CigarResLoss:
    """Residual-stage NLML: the lifted low-fidelity batch (the lift trained
    through the loss) subtracted and standardized; ``rv`` the imputed
    variance (None in subset mode)."""

    gp: CIGP
    tl: TensorLinear

    def __call__(self, p, sx, yl, yh, rv, shift, scale):
        res = (yh - _apply_tl_flat(self.tl, p["tl"], yl) - shift) / scale
        return self.gp.nll(p["gp"], sx, res, y_var=rv)


class CIGAR:
    """Staged CIGP cascade over flattened tensor fields."""

    def __init__(self, fidelity_num: int, kernel_list: Sequence[Kernel],
                 data_shape_list: Sequence[Tuple[int, ...]], if_nonsubset: bool = False,
                 input_dim: int = 1, device="cuda"):
        self.device = resolve_device(device)
        self.fidelity_num = fidelity_num
        self.if_nonsubset = if_nonsubset
        self.input_dim = input_dim
        self.data_shape_list = [tuple(s) for s in data_shape_list]
        self.gp_list: List[CIGP] = [CIGP(kernel=k) for k in kernel_list]
        self.tl_list = [TensorLinear(self.data_shape_list[i], self.data_shape_list[i + 1])
                        for i in range(fidelity_num - 1)]
        self.params = {
            "gp": [gp.init_params(input_dim, device=self.device) for gp in self.gp_list],
            "tl": [tl.init_params(device=self.device) for tl in self.tl_list],
        }
        self.stage_norm = [(0.0, 1.0)] * fidelity_num

    def _apply_tl_flat(self, i: int, params_tl, y_flat):
        return _apply_tl_flat(self.tl_list[i], params_tl, y_flat)

    def forward(self, data_manager: MultiFidelityDataManager, x_test,
                to_fidelity: Optional[int] = None,
                denormalize: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """Cascade: per-column means, the diagonal variance broadcast over
        the columns.  ``x_test`` RAW; per-stage x-normalization."""
        level = to_fidelity if to_fidelity is not None else self.fidelity_num - 1
        dev = self.device
        mean = var = None
        for i in range(level + 1):
            xt_i = stage_x(data_manager, i, x_test, dev)
            if i == 0:
                x_tr, y_tr = data_manager.get_data(0, normal=True)
            else:
                x_tr, y_tr = data_manager.get_data_by_name(f"res-{i}")
                y_tr = y_tr[0] if isinstance(y_tr, list) else y_tr
            y_tr = _f32(y_tr, dev)
            m, v = self.gp_list[i].predict_diag(self.params["gp"][i], _f32(x_tr, dev),
                                                y_tr.reshape(len(y_tr), -1), xt_i)
            v = v[:, None].expand(m.shape)
            if i == 0:
                mean, var = m, v
            else:
                shift, scale = self.stage_norm[i]
                ptl = self.params["tl"][i - 1]
                mean = self._apply_tl_flat(i - 1, ptl, mean) + shift + scale * m
                var = self._apply_tl_flat(i - 1, ptl, var) + scale ** 2 * v
        if denormalize:
            norm = data_manager.normalizelayer[level]
            mean = mean * float(norm.y_std) + float(norm.y_mean)
            var = var * float(norm.y_std) ** 2
        return mean, var

    __call__ = forward


def train_CIGAR(model: CIGAR, data_manager: MultiFidelityDataManager, max_iter: int = 100,
                lr_init: float = 1e-2, n_restarts: int = 4, seed: int = 0,
                debugger=None, n_mesh=None, nshard_min_rows: int = 2048) -> List[torch.Tensor]:
    """Staged training: stage i >= 1 fits the CIGP on the flattened
    standardized residual ``Y_hi - TL_i(Y_lo)`` with the lift trained
    through the NLML; non-subset data add ``|var_hi - var_lo|``.  Returns
    the per-stage loss histories.

    ``n_mesh``: stages of at least ``nshard_min_rows`` rows train through
    the n-axis sharded factorization (`models/ar.py:train_AR`); a residual
    stage rebuilds its lifted target from row slabs inside the sharded
    NLML (`restarts_nll_nsharded(lift=...)`: the lift acts on output
    columns, so it is row-local) and trains the lift through it."""
    dev = model.device
    generator = torch.Generator().manual_seed(seed)
    histories = []
    for i_fid in range(model.fidelity_num):
        gp = model.gp_list[i_fid]
        if i_fid == 0:
            x_low, y_low = data_manager.get_data(0, normal=True)
            x_low, y_low = _f32(x_low, dev), _f32(y_low, dev)
            y_low = y_low.reshape(len(y_low), -1)
            if n_mesh is not None and x_low.shape[0] >= nshard_min_rows:
                good, hist = _run_stage_nsharded(gp, model.params["gp"][0], x_low, y_low, None,
                                                 n_mesh, max_iter, lr_init, n_restarts, generator)
                stage_p = {"gp": good}
            else:
                stage_p, hist = _run_stage(
                    _Cigar0Loss(gp), {"gp": model.params["gp"][0]}, max_iter, lr_init,
                    n_restarts, generator, kernel_spec=gp.kernel, x=x_low, gp_field="gp",
                    loss_args=(x_low, y_low))
            model.params["gp"][0] = stage_p["gp"]
        else:
            tl0 = model.params["tl"][i_fid - 1]
            if model.if_nonsubset:
                subset_x, y_low_p, y_high_p = data_manager.get_nonsubset_fill_data(
                    model, i_fid - 1, i_fid)
                n = len(subset_x)
                sx = _f32(subset_x, dev)
                yl = _f32(y_low_p[0], dev).reshape(n, -1)
                yh = _f32(y_high_p[0], dev).reshape(n, -1)
                rv = torch.abs(_f32(y_high_p[1], dev) - _f32(y_low_p[1], dev))
            else:
                _, y_low, subset_x, y_high = data_manager.get_overlap_input_data(
                    i_fid - 1, i_fid, normal=True)
                n = len(subset_x)
                sx = _f32(subset_x, dev)
                yl, yh = _f32(y_low, dev).reshape(n, -1), _f32(y_high, dev).reshape(n, -1)
                rv = None
            with torch.no_grad():
                shift, scale = _residual_norm(yh - model._apply_tl_flat(i_fid - 1, tl0, yl))
            model.stage_norm[i_fid] = (shift, scale)
            if rv is not None:
                rv = rv / scale ** 2
            stage_p = {"gp": model.params["gp"][i_fid], "tl": tl0}
            if n_mesh is not None and sx.shape[0] >= nshard_min_rows:
                stage_p, hist = _run_stage_nsharded(
                    gp, stage_p, sx, None, (yl, yh, shift, scale), n_mesh, max_iter, lr_init,
                    n_restarts, generator, gp_field="gp",
                    y_var=None if rv is None else rv.reshape(-1), lift=model.tl_list[i_fid - 1])
            else:
                stage_p, hist = _run_stage(
                    _CigarResLoss(gp, model.tl_list[i_fid - 1]), stage_p, max_iter, lr_init,
                    n_restarts, generator, kernel_spec=gp.kernel, x=sx, gp_field="gp",
                    loss_args=(sx, yl, yh, rv, shift, scale))
            model.params["gp"][i_fid] = stage_p["gp"]
            model.params["tl"][i_fid - 1] = stage_p["tl"]
            with torch.no_grad():
                res_final = (yh - model._apply_tl_flat(i_fid - 1, stage_p["tl"], yl)
                             - shift) / scale
            data_manager.add_data(raw_fidelity_name=f"res-{i_fid}", fidelity_index=None,
                                  x=sx.cpu().numpy(), y=[res_final.cpu().numpy(), None])
        histories.append(hist)
        if debugger is not None:
            debugger.record_stage(i_fid, hist)
    return histories
