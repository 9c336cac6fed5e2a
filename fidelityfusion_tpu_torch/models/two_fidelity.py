"""Two-fidelity pedagogic variants (compat surface).

Port of `fidelityfusion_tpu/models/two_fidelity.py`: the API shape of the
reference's hardcoded two-fidelity AR / NAR / ResGP / GAR models,
``Model(); train_X_twofidelity(model, x_train, y_train);
model.forward(x_test)``, as thin wrappers that build a two-fidelity data
manager from the ``(x_train, y_train)`` lists and delegate to the
N-fidelity models, plus `find_subsets_and_indexes`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from fidelityfusion_tpu_torch.models.ar import AR, train_AR
from fidelityfusion_tpu_torch.models.data_manager import MultiFidelityDataManager
from fidelityfusion_tpu_torch.models.gar import GAR, train_GAR
from fidelityfusion_tpu_torch.models.nar import NAR, train_NAR
from fidelityfusion_tpu_torch.models.resgp import ResGP, train_ResGP
from fidelityfusion_tpu_torch.ops.kernels import SquaredExponentialKernel


def find_subsets_and_indexes(x_low, x_high):
    """Rows of ``x_high`` that also occur in ``x_low`` and their indexes,
    matching whole rows for any input dimension (1-D inputs are scalar
    design points).  Returns ``(subset_x, subset_indexes_low,
    subset_indexes_high)``, the first match per low row."""
    xl = np.asarray(x_low)
    xh = np.asarray(x_high)
    xl = xl.reshape(-1, 1) if xl.ndim == 1 else np.atleast_2d(xl)
    xh = xh.reshape(-1, 1) if xh.ndim == 1 else np.atleast_2d(xh)
    if xl.shape[1] != xh.shape[1]:
        raise ValueError(f"x_low and x_high have incompatible input dims "
                         f"{xl.shape[1]} vs {xh.shape[1]}")
    eq = (xl[:, None, :] == xh[None, :, :]).all(-1)
    idx_low, idx_high = np.nonzero(eq)
    _, first = np.unique(idx_low, return_index=True)
    idx_low, idx_high = idx_low[first], idx_high[first]
    return xl[idx_low], idx_low, idx_high


class _TwoFidelityBase:
    """Builds the two-fidelity data manager from the ``(x_train,
    y_train)`` lists, trains the wrapped model and serves `forward`."""

    model = None  # the wrapped N-fidelity model, set by the subclass

    def _fit(self, x_train: Sequence, y_train: Sequence, train_fn, max_iter: int,
             lr_init: float, **kw):
        self.data_manager = MultiFidelityDataManager([
            {"raw_fidelity_name": str(i), "fidelity_indicator": i,
             "X": np.asarray(x_train[i], np.float32), "Y": np.asarray(y_train[i], np.float32)}
            for i in range(2)])
        return train_fn(self.model, self.data_manager, max_iter=max_iter, lr_init=lr_init, **kw)

    def forward(self, x_test) -> Tuple:
        if getattr(self, "data_manager", None) is None:
            raise RuntimeError("train the two-fidelity model before forward()")
        return self.model.forward(self.data_manager, x_test)

    __call__ = forward


def _kernels(kernels):
    return list(kernels) if kernels else [SquaredExponentialKernel()] * 2


class ARTwoFidelity(_TwoFidelityBase):
    """`autoRegression_twofidelity`."""

    def __init__(self, rho_init: float = 1.0, input_dim: int = 1,
                 kernels: Optional[Sequence] = None, device="cuda"):
        self.model = AR(2, _kernels(kernels), rho_init=rho_init, input_dim=input_dim,
                        device=device)

    @property
    def rho(self):
        return self.model.params["rho"][0]


class NARTwoFidelity(_TwoFidelityBase):
    """`NAR_twofidelity`."""

    def __init__(self, input_dim: int = 1, kernels: Optional[Sequence] = None, device="cuda"):
        self.model = NAR(2, _kernels(kernels), input_dim=input_dim, device=device)


class ResGPTwoFidelity(_TwoFidelityBase):
    """`ResGP_twofidelity`."""

    def __init__(self, input_dim: int = 1, kernels: Optional[Sequence] = None, device="cuda"):
        self.model = ResGP(2, _kernels(kernels), input_dim=input_dim, device=device)


class GARTwoFidelity(_TwoFidelityBase):
    """`GAR_twofidelity(l_shape, h_shape)`."""

    def __init__(self, l_shape: Tuple[int, ...], h_shape: Tuple[int, ...],
                 input_dim: int = 1, kernels: Optional[Sequence] = None, device="cuda"):
        self.model = GAR(2, _kernels(kernels), [tuple(l_shape), tuple(h_shape)],
                         input_dim=input_dim, device=device)


def train_AR_twofidelity(ARmodel: ARTwoFidelity, x_train, y_train, max_iter: int = 100,
                         lr_init: float = 1e-1, **kw):
    return ARmodel._fit(x_train, y_train, train_AR, max_iter, lr_init, **kw)


def train_NAR_twofidelity(NARmodel: NARTwoFidelity, x_train, y_train, max_iter: int = 100,
                          lr_init: float = 1e-1, **kw):
    return NARmodel._fit(x_train, y_train, train_NAR, max_iter, lr_init, **kw)


def train_ResGP_twofidelity(ResGPmodel: ResGPTwoFidelity, x_train, y_train,
                            max_iter: int = 100, lr_init: float = 1e-1, **kw):
    return ResGPmodel._fit(x_train, y_train, train_ResGP, max_iter, lr_init, **kw)


def train_GAR_twofidelity(GARmodel: GARTwoFidelity, x_train, y_train, max_iter: int = 100,
                          lr_init: float = 1e-1, **kw):
    return GARmodel._fit(x_train, y_train, train_GAR, max_iter, lr_init, **kw)
