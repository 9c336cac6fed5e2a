"""Carry parameters of the JAX package across to the port.

The JAX package keeps parameters as pytrees of arrays; given as numpy
arrays (e.g. ``jax.tree_util.tree_map(np.asarray, params)``) they become
the port's float32 tensors here, so the same weights can run through both
implementations.
"""

from __future__ import annotations

import numpy as np
import torch

from fidelityfusion_tpu_torch.utils.tree import tree_map


def params_from_numpy(tree, device="cuda"):
    """A parameter tree of numpy arrays (e.g. a CIGP's ``{"kernel": {...},
    "log_beta": ...}``) as float32 tensors on ``device``."""
    return tree_map(
        lambda a: torch.tensor(np.asarray(a, np.float32), device=device), tree)


def load_ar_state(model, params, stage_norm) -> None:
    """Set an `models.ar.AR`'s parameters from the JAX model's ``params``
    (``{"gp": [...], "rho": [...]}`` of numpy arrays) and ``stage_norm``
    (per-stage ``(shift, scale)``)."""
    model.params = params_from_numpy(
        {"gp": list(params["gp"]), "rho": list(params["rho"])}, model.device)
    model.stage_norm = [(float(s), float(c)) for s, c in stage_norm]
