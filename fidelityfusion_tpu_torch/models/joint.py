"""Joint multi-fidelity training: one optimizer step updates every fidelity.

Port of `fidelityfusion_tpu/models/joint.py`: the legacy training
contract, one loss

    L(params) = sum_i NLML_i(stage-i data, params)

minimized by one unbatched Adam (`train/fit.py:fit`) over the whole
parameter tree, so rho / b, the lifts and every stage's kernel co-adapt.
Each step evaluates every stage's NLML: on the card a K1 Gram and a K2 +
K3b factorization per CIGP stage (`se_nlml` for an SE stage of >= 512 rows
without targets' variances, `mvn_nll_hybrid` / `mvn_nll_fused` otherwise),
a K1 Gram per HOGP mode and an exact ``eigh`` per GAR stage (`HOGP.nll`,
never the tracked spectrum).

Non-subset data (``model.if_nonsubset``) train by staged imputation
(`train_joint_nonsubset`): ``rounds`` rounds, each re-imputing the missing
low-fidelity targets with the current cascade (`MultiFidelityDataManager.
get_nonsubset_fill_data`) and then running ``ceil(max_iter / rounds)``
joint steps on the rebuilt stage arrays; stage norms are frozen at round 0.

Afterwards the ``res-i`` / ``concat-i`` datasets and the stage norms are
registered as the staged trainers register them, so ``model.forward``
works unchanged.  Supports AR, ResGP, NAR and staged CAR (subset), and GAR
and CIGAR (subset and non-subset).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from fidelityfusion_tpu_torch.models.ar import AR, _f32, _residual_norm
from fidelityfusion_tpu_torch.models.car import ContinuousAutoRegression, _bind_b
from fidelityfusion_tpu_torch.models.cigar import CIGAR
from fidelityfusion_tpu_torch.models.gar import GAR
from fidelityfusion_tpu_torch.models.nar import NAR
from fidelityfusion_tpu_torch.models.resgp import ResGP
from fidelityfusion_tpu_torch.train.fit import fit


def _np(t):
    return t.detach().cpu().numpy()


def _stage_data(model, dm):
    """Per-stage (x, y_low, y_high) tensors on the model's device (subset
    path); stage 0 has no y_low."""
    dev = model.device
    x0, y0 = dm.get_data(0, normal=True)
    stages = [(_f32(x0, dev), _f32(y0, dev), None)]
    for i in range(1, model.fidelity_num):
        _, yl, sx, yh = dm.get_overlap_input_data(i - 1, i, normal=True)
        stages.append((_f32(sx, dev), _f32(yl, dev), _f32(yh, dev)))
    return stages


def train_joint(model, data_manager, max_iter: int = 200, lr_init: float = 1e-2,
                rounds: int = 4) -> torch.Tensor:
    """Jointly train an AR / ResGP / NAR / staged-CAR / GAR / CIGAR model.

    Subset data: one unbatched Adam run over the sum of the stage NLMLs.
    Non-subset data (``model.if_nonsubset``): `train_joint_nonsubset`
    (staged imputation; ``rounds`` sets the re-imputation cadence).

    Returns the loss history ``(max_iter,)``.  The residual / concat
    datasets and stage norms are registered afterwards from the final
    parameters, so the prediction cascade behaves as after staged
    training."""
    if getattr(model, "if_nonsubset", False):
        return train_joint_nonsubset(model, data_manager, max_iter=max_iter, lr_init=lr_init,
                                     rounds=rounds)
    if isinstance(model, (GAR, CIGAR)):
        return _train_joint_tensor(model, data_manager, max_iter, lr_init)
    if not isinstance(model, (AR, ResGP, NAR, ContinuousAutoRegression)):
        raise TypeError(f"joint training not supported for {type(model).__name__}")
    stages = _stage_data(model, data_manager)
    x0, y0, _ = stages[0]

    if isinstance(model, NAR):
        concat = [(torch.cat([sx, yl.reshape(len(sx), -1)], dim=-1), yh)
                  for (sx, yl, yh) in stages[1:]]

        def loss_fn(p):
            total = model.gp_list[0].nll(p["gp"][0], x0, y0)
            for i, (cx, yh) in enumerate(concat, start=1):
                total = total + model.gp_list[i].nll(p["gp"][i], cx, yh)
            return total

        result = fit(loss_fn, model.params, steps=max_iter, lr=lr_init)
        model.params = result.params
        for i, (cx, yh) in enumerate(concat, start=1):
            data_manager.add_data(f"concat-{i}", None, _np(cx), [_np(yh), None])
        return result.losses

    # the rho-residual cascades: res_i = (y_hi - rho_i(p) y_lo - shift) / scale
    if isinstance(model, AR):
        def rho(p, i):
            return p["rho"][i - 1]
    elif isinstance(model, ResGP):
        def rho(p, i):
            return 1.0
    else:  # staged CAR: one global b, bound into every residual kernel
        def rho(p, i):
            return torch.exp(p["b"])

    def stage_params(p, i):
        if isinstance(model, ContinuousAutoRegression):
            return _bind_b(p["gp"][i], p["b"])
        return p["gp"][i]

    with torch.no_grad():
        norms = [(0.0, 1.0)] + [_residual_norm(yh - rho(model.params, i) * yl)
                                for i, (_, yl, yh) in enumerate(stages[1:], start=1)]

    def residual(p, i):
        _, yl, yh = stages[i]
        shift, scale = norms[i]
        return (yh - rho(p, i) * yl - shift) / scale

    def loss_fn(p):
        total = model.gp_list[0].nll(p["gp"][0], x0, y0)
        for i in range(1, model.fidelity_num):
            total = total + model.gp_list[i].nll(stage_params(p, i), stages[i][0],
                                                 residual(p, i))
        return total

    result = fit(loss_fn, model.params, steps=max_iter, lr=lr_init)
    model.params = result.params
    model.stage_norm = norms
    with torch.no_grad():
        for i in range(1, model.fidelity_num):
            data_manager.add_data(f"res-{i}", None, _np(stages[i][0]),
                                  [_np(residual(model.params, i)), None])
    return result.losses


# --------------------------------------------------------------------------
# Joint training of the tensor-output models (GAR / CIGAR)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _JointGarLoss:
    """Joint NLML over a GAR cascade: the stage HOGPs' exact Kronecker
    NLMLs (`HOGP.nll`: an ``eigh`` of every stage's K_0 each step), with
    the TensorLinear lifts trained through them.  Stage arrays are (sx,
    yl, yh, rv) quads; ``rv`` is the imputed residual variance, a row of
    zeros on subset data, so one loss serves both paths."""

    hogps: tuple
    tls: tuple
    norms: tuple  # per-stage (shift, scale) floats

    def __call__(self, p, x0, y0, *stage_arrays):
        total = self.hogps[0].nll(p["hogp"][0], x0, y0)
        for i in range(1, len(self.hogps)):
            sx, yl, yh, rv = stage_arrays[4 * (i - 1): 4 * i]
            shift, scale = self.norms[i]
            res = (yh - self.tls[i - 1].apply(p["tl"][i - 1], yl) - shift) / scale
            total = total + self.hogps[i].nll(p["hogp"][i], sx, res, y_var=rv)
        return total


@dataclasses.dataclass(frozen=True)
class _JointCigarLoss:
    """Joint NLML over a CIGAR cascade (outputs flattened through CIGP).
    ``rv`` always reaches the CIGP as ``y_var`` (zeros on subset data), so
    every stage takes the `build_sigma` route (`mvn_nll_hybrid` /
    `mvn_nll_fused`), as in the JAX package."""

    gps: tuple
    tls: tuple
    norms: tuple

    def __call__(self, p, x0, y0, *stage_arrays):
        total = self.gps[0].nll(p["gp"][0], x0, y0)
        for i in range(1, len(self.gps)):
            sx, yl, yh, rv = stage_arrays[4 * (i - 1): 4 * i]
            shift, scale = self.norms[i]
            tl = self.tls[i - 1]
            lift = tl.apply(p["tl"][i - 1], yl.reshape((yl.shape[0],) + tuple(tl.l_shape)))
            res = (yh - lift.reshape(lift.shape[0], -1) - shift) / scale
            total = total + self.gps[i].nll(p["gp"][i], sx, res, y_var=rv)
        return total


def _tensor_targets(model, i, sx, yl, yh):
    """(yl, yh) of stage i as fields (GAR) or flattened rows (CIGAR)."""
    n = len(sx)
    if isinstance(model, GAR):
        return (yl.reshape((n,) + model.data_shape_list[i - 1]),
                yh.reshape((n,) + model.data_shape_list[i]))
    return yl.reshape(n, -1), yh.reshape(n, -1)


def _tensor_x0(model, dm):
    x0, y0 = dm.get_data(0, normal=True)
    x0, y0 = _f32(x0, model.device), _f32(y0, model.device)
    return x0, (y0 if isinstance(model, GAR) else y0.reshape(len(y0), -1))


def _tensor_stage_arrays_subset(model, dm):
    """(x0, y0, stage quads) for GAR/CIGAR subset joint training; y kept
    as fields for GAR, flattened for CIGAR; ``rv`` zeros."""
    dev = model.device
    x0, y0 = _tensor_x0(model, dm)
    quads = []
    for i in range(1, model.fidelity_num):
        _, yl, sx, yh = dm.get_overlap_input_data(i - 1, i, normal=True)
        sx = _f32(sx, dev)
        yl, yh = _tensor_targets(model, i, sx, _f32(yl, dev), _f32(yh, dev))
        quads.append((sx, yl, yh, torch.zeros((len(sx),), device=dev)))
    return x0, y0, quads


def _tensor_lift(model, i, p_tl, yl):
    if isinstance(model, GAR):
        return model.tl_list[i - 1].apply(p_tl, yl)
    return model._apply_tl_flat(i - 1, p_tl, yl)


def _register_tensor_stages(model, dm, x0, y0, quads):
    """Re-register the ``res-i`` datasets and (GAR) the posterior states
    from the CURRENT parameters, so `model.forward` reflects the joint fit.

    ``res-i`` is stored without a variance, as the JAX package stores it
    (the port's staged `train_GAR` stores the imputed one).  A GAR stage's
    state is built with its imputed variance ``rv`` on K_0's diagonal when
    ``rv`` is non-zero (non-subset rows that were imputed), else without:
    so after a joint fit `GAR.rebuild_states`, which reads ``res-i``, sees
    no variance and rebuilds a non-subset stage's state without it, as a
    rebuild from the JAX cascade's datasets would; the states this
    function leaves keep it."""
    is_gar = isinstance(model, GAR)
    with torch.no_grad():
        if is_gar:
            _, model.states[0] = model.hogp_list[0].nll_with_state(
                model.params["hogp"][0], x0, y0)
        for i, (sx, yl, yh, rv) in enumerate(quads, start=1):
            shift, scale = model.stage_norm[i]
            res = (yh - _tensor_lift(model, i, model.params["tl"][i - 1], yl) - shift) / scale
            dm.data_dict.pop(f"res-{i}", None)
            dm.add_data(f"res-{i}", None, _np(sx), [_np(res), None])
            if is_gar:
                has_var = bool(torch.any(rv != 0))
                _, model.states[i] = model.hogp_list[i].nll_with_state(
                    model.params["hogp"][i], sx, res, y_var=rv if has_var else None)


def _tensor_loss(model, norms):
    if isinstance(model, GAR):
        return _JointGarLoss(tuple(model.hogp_list), tuple(model.tl_list), norms)
    return _JointCigarLoss(tuple(model.gp_list), tuple(model.tl_list), norms)


def _set_tensor_norm(model, i, yl, yh):
    with torch.no_grad():
        model.stage_norm[i] = _residual_norm(
            yh - _tensor_lift(model, i, model.params["tl"][i - 1], yl))


def _train_joint_tensor(model, dm, max_iter, lr_init):
    """Subset joint training of GAR/CIGAR: one Adam over every stage's
    HOGP/CIGP NLML with the TensorLinear lifts co-adapting; the residual
    standardization is fixed from the INITIAL lifts (as the staged
    trainers fix it before a stage trains)."""
    x0, y0, quads = _tensor_stage_arrays_subset(model, dm)
    for i, (_, yl, yh, _) in enumerate(quads, start=1):
        _set_tensor_norm(model, i, yl, yh)
    norms = tuple((float(s), float(c)) for s, c in model.stage_norm)
    flat = [a for quad in quads for a in quad]
    result = fit(_tensor_loss(model, norms), model.params, steps=max_iter, lr=lr_init,
                 loss_args=(x0, y0, *flat))
    model.params = result.params
    _register_tensor_stages(model, dm, x0, y0, quads)
    return result.losses


def _train_joint_tensor_nonsubset(model, dm, max_iter, lr_init, rounds):
    """Non-subset joint GAR/CIGAR by staged imputation (the rounds of
    `train_joint_nonsubset`): before each round the missing low-fidelity
    fields are imputed with the CURRENT cascade (GAR's stage-0 state is
    refreshed from the current parameters first, so round 0 imputes with
    the initialized model), then one joint Adam run on the stage arrays.
    ``rv = |var_hi - var_lo| / scale^2`` enters each stage's diagonal."""
    dev = model.device
    is_gar = isinstance(model, GAR)
    steps_per_round = max(1, math.ceil(max_iter / rounds))
    x0, y0 = _tensor_x0(model, dm)
    all_losses = []
    norms = None
    for _ in range(rounds):
        if is_gar:
            with torch.no_grad():
                _, model.states[0] = model.hogp_list[0].nll_with_state(
                    model.params["hogp"][0], x0, y0)
        quads = []
        for i in range(1, model.fidelity_num):
            sx, y_low_p, y_high_p = dm.get_nonsubset_fill_data(model, i - 1, i)
            sx = _f32(sx, dev)
            yl, yh = _tensor_targets(model, i, sx, _f32(y_low_p[0], dev),
                                     _f32(y_high_p[0], dev))
            rv = torch.abs(_f32(y_high_p[1], dev) - _f32(y_low_p[1], dev)).reshape(-1)
            if norms is None:
                _set_tensor_norm(model, i, yl, yh)
            _, scale = model.stage_norm[i]
            quads.append((sx, yl, yh, rv / torch.tensor(scale, dtype=torch.float32) ** 2))
            # register res-i (and GAR's state i) now, so fidelity i+1's
            # imputation cascade sees this stage
            _register_tensor_stages(model, dm, x0, y0, quads)
        if norms is None:
            norms = tuple((float(s), float(c)) for s, c in model.stage_norm)
        flat = [a for quad in quads for a in quad]
        result = fit(_tensor_loss(model, norms), model.params, steps=steps_per_round,
                     lr=lr_init, loss_args=(x0, y0, *flat))
        model.params = result.params
        all_losses.append(result.losses)
        _register_tensor_stages(model, dm, x0, y0, quads)
    return torch.cat(all_losses)


# --------------------------------------------------------------------------
# Non-subset joint training: staged imputation
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _JointRhoLoss:
    """Joint NLML over a rho-residual cascade (AR; ResGP with
    ``trainable_rho=False``, rho fixed at 1).  The imputed low-fidelity
    targets carry variances, on the stage covariance's diagonal as in
    `models/ar.py:_ResidualVarLoss`."""

    gps: tuple  # per-stage CIGP specs
    norms: tuple  # per-stage (shift, scale) floats
    trainable_rho: bool

    def __call__(self, p, x0, y0, *stage_arrays):
        total = self.gps[0].nll(p["gp"][0], x0, y0)
        for i in range(1, len(self.gps)):
            sx, yl_m, yl_v, yh_m, yh_v = stage_arrays[5 * (i - 1): 5 * i]
            rho = p["rho"][i - 1] if self.trainable_rho else 1.0
            shift, scale = self.norms[i]
            res = (yh_m - rho * yl_m - shift) / scale
            res_var = torch.abs(yh_v - rho * yl_v) / scale ** 2
            total = total + self.gps[i].nll(p["gp"][i], sx, res, y_var=res_var)
        return total


@dataclasses.dataclass(frozen=True)
class _JointNARLoss:
    """Joint NLML over a NAR cascade: stage i's input is ``[x, y_low(x)]``
    with y_low imputed where unobserved.  ``y_var`` carries ``sum(yl_v) *
    0`` as the JAX package's does: it keeps every stage on the
    `build_sigma` route and lets a NaN imputed variance through."""

    gps: tuple

    def __call__(self, p, x0, y0, *stage_arrays):
        total = self.gps[0].nll(p["gp"][0], x0, y0)
        for i in range(1, len(self.gps)):
            sx, yl_m, yl_v, yh_m, yh_v = stage_arrays[5 * (i - 1): 5 * i]
            cx = torch.cat([sx, yl_m.reshape(sx.shape[0], -1)], dim=-1)
            total = total + self.gps[i].nll(p["gp"][i], cx, yh_m,
                                            y_var=yh_v + torch.sum(yl_v) * 0.0)
        return total


def _joint_rho(model):
    """(trainable_rho, rho values) of a rho-residual cascade model."""
    if isinstance(model, AR):
        return True, model.params["rho"]
    return False, [torch.tensor(1.0, device=model.device)] * (model.fidelity_num - 1)


def _register_stage_datasets(model, dm, stage_arrays):
    """(Re-)register the ``res-i`` / ``concat-i`` datasets from the CURRENT
    parameters, so `model.forward` (and the next round's imputation) sees
    them.  `add_data` appends on a re-add, so the stale entry goes first."""
    is_nar = isinstance(model, NAR)
    _, rhos = _joint_rho(model)
    with torch.no_grad():
        for i in range(1, len(stage_arrays) // 5 + 1):
            sx, yl_m, yl_v, yh_m, yh_v = stage_arrays[5 * (i - 1): 5 * i]
            if is_nar:
                cx = torch.cat([sx, yl_m.reshape(len(sx), -1)], dim=-1)
                dm.data_dict.pop(f"concat-{i}", None)
                dm.add_data(f"concat-{i}", None, _np(cx), [_np(yh_m), None])
            else:
                rho = model.params["rho"][i - 1] if isinstance(model, AR) else rhos[i - 1]
                shift, scale = model.stage_norm[i]
                res = (yh_m - rho * yl_m - shift) / scale
                res_var = torch.abs(yh_v - rho * yl_v) / scale ** 2
                dm.data_dict.pop(f"res-{i}", None)
                dm.add_data(f"res-{i}", None, _np(sx), [_np(res), _np(res_var)])


def train_joint_nonsubset(model, data_manager, max_iter: int = 200, lr_init: float = 1e-2,
                          rounds: int = 4) -> torch.Tensor:
    """Joint training on NON-SUBSET data by staged imputation: each of
    ``rounds`` rounds re-imputes the missing low-fidelity targets with the
    current cascade (`get_nonsubset_fill_data`), then runs ``ceil(max_iter
    / rounds)`` joint Adam steps on the rebuilt stage arrays.

    Supports AR, ResGP, NAR, GAR and CIGAR (the joint formulation of CAR
    is `ContinuousAutoRegressionLarge`).  Returns the concatenated loss
    history (``rounds * ceil(max_iter / rounds)`` steps)."""
    if isinstance(model, ContinuousAutoRegression):
        raise TypeError("non-subset joint CAR: use ContinuousAutoRegressionLarge (the "
                        "joint ContinuAR formulation, models/car.py) instead")
    if isinstance(model, (GAR, CIGAR)):
        return _train_joint_tensor_nonsubset(model, data_manager, max_iter, lr_init, rounds)
    if not isinstance(model, (AR, ResGP, NAR)):
        raise TypeError(f"non-subset joint training not supported for {type(model).__name__}")
    dev = model.device
    steps_per_round = max(1, math.ceil(max_iter / rounds))
    x0, y0 = data_manager.get_data(0, normal=True)
    x0, y0 = _f32(x0, dev), _f32(y0, dev)

    trainable_rho, rhos = _joint_rho(model)
    all_losses = []
    norms = None
    for _ in range(rounds):
        stage_arrays = []
        for i in range(1, model.fidelity_num):
            sx, y_low_p, y_high_p = data_manager.get_nonsubset_fill_data(model, i - 1, i)
            sx = _f32(sx, dev)
            yl_m, yl_v = _f32(y_low_p[0], dev), _f32(y_low_p[1], dev)
            yh_m, yh_v = _f32(y_high_p[0], dev), _f32(y_high_p[1], dev)
            if norms is None and not isinstance(model, NAR):
                # stage norms fixed at round 0, with the initial rho
                with torch.no_grad():
                    model.stage_norm[i] = _residual_norm(yh_m - rhos[i - 1] * yl_m)
            stage_arrays.extend([sx, yl_m, yl_v, yh_m, yh_v])
            # register res/concat-i now, so fidelity i+1's imputation
            # cascade (and the next round's) sees this stage
            _register_stage_datasets(model, data_manager, stage_arrays)
        if norms is None:
            norms = tuple((float(s), float(c)) for s, c in getattr(
                model, "stage_norm", [(0.0, 1.0)] * model.fidelity_num))

        if isinstance(model, NAR):
            loss_fn = _JointNARLoss(tuple(model.gp_list))
        else:
            loss_fn = _JointRhoLoss(tuple(model.gp_list), norms, trainable_rho)
        result = fit(loss_fn, model.params, steps=steps_per_round, lr=lr_init,
                     loss_args=(x0, y0, *stage_arrays))
        model.params = result.params
        all_losses.append(result.losses)
        _register_stage_datasets(model, data_manager, stage_arrays)
    return torch.cat(all_losses)
