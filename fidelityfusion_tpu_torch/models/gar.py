"""GAR: generalized autoregression for tensor-valued (field) outputs.

Port of `fidelityfusion_tpu/models/gar.py`: per-fidelity HOGP surrogates over
tensor outputs, coupled by trainable `TensorLinear` per-mode lifts where
the fidelities' output grids differ:

    Y_hi(x) = TL_i(Y_lo(x)) + Res_i(x)

Training is staged as AR's: stage 0 fits a HOGP to fidelity 0, stage i
fits one to the standardized residual ``Y_hi - TL_i(Y_lo)`` with the lift
trained through the HOGP NLML.  Stages of at least `_TRACK_N_THRESHOLD`
rows train through the tracked-spectrum NLML (`HOGP.nll_tracked`: a full
``eigh`` every 64 steps, Jacobi sweeps in between); smaller ones pay the
exact ``eigh`` every step.  Each stage keeps an explicit `HOGPState` for
`forward`; `rebuild_states` makes them from loaded parameters.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from fidelityfusion_tpu_torch.models.ar import _f32, _residual_norm, _run_stage, stage_x
from fidelityfusion_tpu_torch.models.coupling import TensorLinear
from fidelityfusion_tpu_torch.models.data_manager import MultiFidelityDataManager
from fidelityfusion_tpu_torch.models.hogp import HOGP, HOGPState
from fidelityfusion_tpu_torch.ops.kernels import Kernel
from fidelityfusion_tpu_torch.utils.device import resolve_device

# Stages of at least this many rows train through the tracked-spectrum
# NLML, where one eigh of the n x n Gram a step is the cost to avoid.
_TRACK_N_THRESHOLD = 512


@dataclasses.dataclass(frozen=True)
class _Gar0Loss:
    """Stage-0 HOGP NLML."""

    hogp: HOGP

    def __call__(self, p, x, y):
        return self.hogp.nll(p["hogp"], x, y)


@dataclasses.dataclass(frozen=True)
class _GarResLoss:
    """Residual-stage HOGP NLML with the TensorLinear lift trained through
    it; ``rv`` is the imputed variance (None in subset mode)."""

    hogp: HOGP
    tl: TensorLinear

    def __call__(self, p, sx, yl, yh, rv, shift, scale):
        res = (yh - self.tl.apply(p["tl"], yl) - shift) / scale
        return self.hogp.nll(p["hogp"], sx, res, y_var=rv)


@dataclasses.dataclass(frozen=True)
class _Gar0LossTracked:
    """`_Gar0Loss` through the tracked-spectrum NLML (aux-carry signature,
    `train.fit.adam_scan_aux`).  ``refresh_every`` sets the calendar; the
    segmented adaptive trainer (`fit_restarts_tracked_adaptive`) passes a
    huge value so only each segment's step 0 refreshes."""

    hogp: HOGP
    refresh_every: int = 64

    def __call__(self, p, aux, step, x, y):
        return self.hogp.nll_tracked(p["hogp"], aux, step, x, y,
                                     refresh_every=self.refresh_every)


@dataclasses.dataclass(frozen=True)
class _GarResLossTracked:
    """`_GarResLoss` through the tracked-spectrum NLML."""

    hogp: HOGP
    tl: TensorLinear
    refresh_every: int = 64

    def __call__(self, p, aux, step, sx, yl, yh, rv, shift, scale):
        res = (yh - self.tl.apply(p["tl"], yl) - shift) / scale
        return self.hogp.nll_tracked(p["hogp"], aux, step, sx, res, y_var=rv,
                                     refresh_every=self.refresh_every)


def _nshard(mesh, rows: int, min_rows: int) -> bool:
    """Whether a stage of ``rows`` rows trains n-sharded on ``mesh``: at
    least ``min_rows`` rows, divisible by the "n" size."""
    if mesh is None or rows < min_rows:
        return False
    from fidelityfusion_tpu_torch.parallel.mesh import axis_size

    return rows % axis_size(mesh, "n") == 0


class GAR:
    """Staged HOGP cascade over tensor fields; ``data_shape_list`` gives
    each fidelity's per-sample output shape."""

    def __init__(self, fidelity_num: int, kernel_list: Sequence[Kernel],
                 data_shape_list: Sequence[Tuple[int, ...]], if_nonsubset: bool = False,
                 input_dim: int = 1, device="cuda"):
        self.device = resolve_device(device)
        self.fidelity_num = fidelity_num
        self.if_nonsubset = if_nonsubset
        self.input_dim = input_dim
        self.data_shape_list = [tuple(s) for s in data_shape_list]
        # stage i models fidelity i's field (the residual lives on grid i)
        last = len(self.data_shape_list) - 1
        self.hogp_list: List[HOGP] = [
            HOGP(kernel=kernel_list[i], output_shape=self.data_shape_list[min(i, last)])
            for i in range(fidelity_num)]
        self.tl_list = [TensorLinear(self.data_shape_list[i], self.data_shape_list[i + 1])
                        for i in range(fidelity_num - 1)]
        self.params = {
            "hogp": [h.init_params(input_dim, device=self.device) for h in self.hogp_list],
            "tl": [tl.init_params(device=self.device) for tl in self.tl_list],
        }
        self.states: List[Optional[HOGPState]] = [None] * fidelity_num
        self.stage_norm = [(0.0, 1.0)] * fidelity_num

    def _stage_train_data(self, data_manager, i):
        if i == 0:
            x_tr, y_tr = data_manager.get_data(0, normal=True)
            y_var = None
        else:
            x_tr, y_tr = data_manager.get_data_by_name(f"res-{i}")
            y_tr, y_var = y_tr if isinstance(y_tr, list) else (y_tr, None)
        t = lambda a: None if a is None else _f32(a, self.device)  # noqa: E731
        return t(x_tr), t(y_tr), t(y_var)

    def rebuild_states(self, data_manager: MultiFidelityDataManager) -> None:
        """Each stage's `HOGPState` from the current parameters and the
        stage datasets in ``data_manager`` (fidelity 0 and the ``res-i``
        residuals that training registers), e.g. after `convert.load_state`
        carried a JAX-trained GAR across.  A non-subset stage's imputed
        variance is the second entry of its ``res-i`` targets, which the
        port's trainer stores and the JAX package's does not."""
        with torch.no_grad():
            for i in range(self.fidelity_num):
                x, y, y_var = self._stage_train_data(data_manager, i)
                _, self.states[i] = self.hogp_list[i].nll_with_state(
                    self.params["hogp"][i], x, y, y_var=y_var)

    def forward(self, data_manager: MultiFidelityDataManager, x_test,
                to_fidelity: Optional[int] = None,
                denormalize: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """Cascade: ``mean_hi = TL(mean_lo) + shift + scale * mean_res``,
        ``var_hi = TL(var_lo) + scale^2 var_res`` (per-element diagonal
        variances).  ``x_test`` RAW; each stage normalizes it with its own
        x-statistics."""
        level = to_fidelity if to_fidelity is not None else self.fidelity_num - 1
        mean = var = None
        for i in range(level + 1):
            xt_i = stage_x(data_manager, i, x_test, self.device)
            x_tr, _, _ = self._stage_train_data(data_manager, i)
            state = self.states[i]
            if state is None:
                raise RuntimeError("GAR.forward called before train_GAR")
            m_i, v_i = self.hogp_list[i].predict(self.params["hogp"][i], state, x_tr, xt_i)
            if i == 0:
                mean, var = m_i, v_i
            else:
                tl, ptl = self.tl_list[i - 1], self.params["tl"][i - 1]
                shift, scale = self.stage_norm[i]
                mean = tl.apply(ptl, mean) + shift + scale * m_i
                var = tl.apply(ptl, var) + scale ** 2 * v_i
        if denormalize:
            norm = data_manager.normalizelayer[level]
            mean = mean * float(norm.y_std) + float(norm.y_mean)
            var = var * float(norm.y_std) ** 2
        return mean, var

    __call__ = forward


def train_GAR(model: GAR, data_manager: MultiFidelityDataManager, max_iter: int = 100,
              lr_init: float = 1e-2, n_restarts: int = 4, seed: int = 0,
              debugger=None, n_mesh=None, nshard_min_rows: int = 2048) -> List[torch.Tensor]:
    """Staged training: stage i >= 1 fits the HOGP on the standardized
    residual ``Y_hi - TL_i(Y_lo)`` with the lift trained through the NLML;
    non-subset data add the imputed variance ``|var_hi - var_lo|`` to K_0's
    diagonal.  Returns the per-stage loss histories.

    ``n_mesh``: a mesh with an ``"n"`` dim; stages of at least
    ``nshard_min_rows`` rows that divide by its size train through the
    n-axis sharded tracked Kronecker NLML (`parallel/kron_nsharded.py:
    fit_hogp_nsharded`: one initialization, refreshes every 64 steps);
    smaller stages keep the restart path."""
    dev = model.device
    generator = torch.Generator().manual_seed(seed)
    histories = []
    for i_fid in range(model.fidelity_num):
        hogp = model.hogp_list[i_fid]
        if i_fid == 0:
            x_low, y_low = data_manager.get_data(0, normal=True)
            x_low, y_low = _f32(x_low, dev), _f32(y_low, dev)
            if _nshard(n_mesh, x_low.shape[0], nshard_min_rows):
                from fidelityfusion_tpu_torch.parallel.kron_nsharded import fit_hogp_nsharded

                good, hist, _ = fit_hogp_nsharded(hogp, model.params["hogp"][0], x_low, y_low,
                                                  n_mesh, steps=max_iter, lr=lr_init,
                                                  refresh_every=64)
                stage_p = {"hogp": good}
            else:
                tracked = x_low.shape[0] >= _TRACK_N_THRESHOLD
                stage_p, hist = _run_stage(
                    _Gar0LossTracked(hogp) if tracked else _Gar0Loss(hogp),
                    {"hogp": model.params["hogp"][0]}, max_iter, lr_init, n_restarts,
                    generator, kernel_spec=hogp.kernel, x=x_low, gp_field="hogp",
                    loss_args=(x_low, y_low),
                    aux0=hogp.tracking_aux0(x_low.shape[0], dev) if tracked else None)
            model.params["hogp"][0] = stage_p["hogp"]
            with torch.no_grad():
                _, model.states[0] = hogp.nll_with_state(stage_p["hogp"], x_low, y_low)
        else:
            tl = model.tl_list[i_fid - 1]
            tl0 = model.params["tl"][i_fid - 1]
            if model.if_nonsubset:
                subset_x, y_low_p, y_high_p = data_manager.get_nonsubset_fill_data(
                    model, i_fid - 1, i_fid)
                n = len(subset_x)
                sx = _f32(subset_x, dev)
                yl = _f32(y_low_p[0], dev).reshape((n,) + model.data_shape_list[i_fid - 1])
                yh = _f32(y_high_p[0], dev).reshape((n,) + model.data_shape_list[i_fid])
                rv = torch.abs(_f32(y_high_p[1], dev) - _f32(y_low_p[1], dev))
            else:
                _, y_low, subset_x, y_high = data_manager.get_overlap_input_data(
                    i_fid - 1, i_fid, normal=True)
                sx, yl, yh, rv = _f32(subset_x, dev), _f32(y_low, dev), _f32(y_high, dev), None
            with torch.no_grad():
                shift, scale = _residual_norm(yh - tl.apply(tl0, yl))
            model.stage_norm[i_fid] = (shift, scale)
            if rv is not None:
                rv = rv / scale ** 2
            stage_p = {"hogp": model.params["hogp"][i_fid], "tl": tl0}
            if _nshard(n_mesh, sx.shape[0], nshard_min_rows):
                from fidelityfusion_tpu_torch.parallel.kron_nsharded import fit_hogp_nsharded

                stage_p, hist, _ = fit_hogp_nsharded(
                    hogp, stage_p, sx, None, n_mesh, steps=max_iter, lr=lr_init,
                    refresh_every=64, y_var=rv, residual=(tl, yl, yh, shift, scale))
            else:
                tracked = sx.shape[0] >= _TRACK_N_THRESHOLD
                stage_p, hist = _run_stage(
                    _GarResLossTracked(hogp, tl) if tracked else _GarResLoss(hogp, tl),
                    stage_p, max_iter, lr_init, n_restarts, generator,
                    kernel_spec=hogp.kernel, x=sx, gp_field="hogp",
                    loss_args=(sx, yl, yh, rv, shift, scale),
                    aux0=hogp.tracking_aux0(sx.shape[0], dev) if tracked else None)
            model.params["hogp"][i_fid] = stage_p["hogp"]
            model.params["tl"][i_fid - 1] = stage_p["tl"]
            # the final residual dataset and posterior state for the cascade
            with torch.no_grad():
                res_final = (yh - tl.apply(stage_p["tl"], yl) - shift) / scale
                _, model.states[i_fid] = hogp.nll_with_state(stage_p["hogp"], sx, res_final,
                                                             y_var=rv)
            data_manager.add_data(
                raw_fidelity_name=f"res-{i_fid}", fidelity_index=None, x=sx.cpu().numpy(),
                y=[res_final.cpu().numpy(), None if rv is None else rv.cpu().numpy()])
        histories.append(hist)
        if debugger is not None:
            debugger.record_stage(i_fid, hist)
    return histories
