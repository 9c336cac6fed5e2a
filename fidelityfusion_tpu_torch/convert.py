"""Carry parameters of the JAX package across to the port.

The JAX package keeps parameters as pytrees of arrays; given as numpy
arrays (e.g. ``jax.tree_util.tree_map(np.asarray, params)``) they become
the port's float32 tensors here, so the same weights run through both
implementations (a `CIGPWithMean`'s ``const_mean`` with the rest).  The
Monte-Carlo draws that the JAX models keep under ``_`` keys
(`MCFidelityKernel`'s ``_z``, `ContinuousFidelityKernel`'s ``_w`` and
``_t``, FIDES's ``_u``) come across with them: loaded from a JAX model's
initial parameters, a port model trains from exactly the JAX package's
init.  `net_params_from_numpy` carries the real-application objectives'
network weights across.
"""

from __future__ import annotations

import numpy as np
import torch

from fidelityfusion_tpu_torch.utils.tree import tree_map


def params_from_numpy(tree, device="cuda"):
    """A parameter tree of numpy arrays (nested dicts, lists and tuples:
    a CIGP's ``{"kernel": {...}, "log_beta": ...}``, FIDES's parameters)
    as float32 tensors on ``device``."""
    return tree_map(
        lambda a: torch.tensor(np.asarray(a, np.float32), device=device), tree)


def net_params_from_numpy(params, device="cuda"):
    """A network's parameters from the JAX package's real-application
    objectives (`data/real_app.py`: a dict of numpy arrays) as float32
    tensors for the port's `nn.Module`s: 4-D conv kernels go from HWIO to
    OIHW; dense weights keep their (in, out) layout, whose rows the port's
    CNNs flatten in the same (h, w, c) order."""
    def one(a):
        t = torch.tensor(np.asarray(a, np.float32), device=device)
        return t.permute(3, 2, 0, 1).contiguous() if t.ndim == 4 else t
    return {k: one(a) for k, a in params.items()}


def load_state(model, params, stage_norm=None, data_manager=None, train_data=None) -> None:
    """Set a model's parameters from the JAX model's ``params`` (numpy
    arrays) and, for the models that standardize residuals per stage,
    ``stage_norm`` (per-stage ``(shift, scale)``).  One loader for every
    cascade: `AR` (``{"gp": [...], "rho": [...]}``), `ResGP` and `NAR`
    (``{"gp": [...]}``), staged CAR (``{"gp": [...], "b": ...}``, each
    residual kernel with its ``_z``), CAR-large (one GPBasic's parameters,
    its kernel with ``_w`` and ``_t``), `GAR` (``{"hogp": [...], "tl":
    [...]}``) and `CIGAR` (``{"gp": [...], "tl": [...]}``).  A cascade
    trained jointly (`models/joint.py`) has the same trees as a staged one;
    its ``res-i`` / ``concat-i`` datasets go into the port's data manager
    as the staged ones do.

    A GAR predicts from per-stage posterior states: given the
    ``data_manager`` that holds its stage datasets (fidelity 0 and the
    ``res-i`` residuals of training), they are rebuilt from the loaded
    parameters (`GAR.rebuild_states`).

    The legacy wrappers (`models/legacy.py`: `LegacyCIGP`, `LegacyHOGP`,
    `LegacyFIDES`) take their core's parameters and, as ``train_data``,
    the ``(train_x, train_y)`` they cached; a `LegacyHOGP`'s posterior
    state is then made anew at its next `forward`."""
    model.params = params_from_numpy(params, model.device)
    if stage_norm is not None:
        model.stage_norm = [(float(s), float(c)) for s, c in stage_norm]
    if data_manager is not None and hasattr(model, "rebuild_states"):
        model.rebuild_states(data_manager)
    if train_data is not None:
        model.train_x, model.train_y = (
            torch.tensor(np.asarray(a, np.float32), device=model.device) for a in train_data)
        if hasattr(model, "_state"):
            model._state = None
