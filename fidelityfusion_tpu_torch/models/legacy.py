"""Legacy config-driven API adapters.

Port of `fidelityfusion_tpu/models/legacy.py`: the `MFGP_ver2023May`
model contract, config-dict construction merged over defaults
(`utils/config.py:update_dict_with_default`) plus

    forward(x, x_var=0.) / compute_loss(x, y, ..., update_data=False)

as thin stateful wrappers over the port's `CIGP`, `HOGP` and `FIDES`.  A
wrapper caches its training data at the first `compute_loss` (or on
``update_data``); `compute_loss` returns the NLML to minimize; `fit` is a
convenience Adam trainer (`train/fit.py:fit`, unbatched: K1, and K2 + K3b
for CIGP and FIDES, on the card).  Each wrapper keeps its tensors on
``device`` (default ``"cuda"``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from fidelityfusion_tpu_torch.models.ar import _f32
from fidelityfusion_tpu_torch.models.cigp import CIGP as CIGPCore
from fidelityfusion_tpu_torch.models.fides import FIDES as FIDESCore, FidelityBounds
from fidelityfusion_tpu_torch.models.hogp import HOGP as HOGPCore
from fidelityfusion_tpu_torch.ops.kernels import ARDKernel, Kernel, SquaredExponentialKernel
from fidelityfusion_tpu_torch.train.fit import fit
from fidelityfusion_tpu_torch.utils.config import update_dict_with_default
from fidelityfusion_tpu_torch.utils.device import resolve_device

KERNEL_REGISTRY = {
    "SE": SquaredExponentialKernel,
    "ARD": ARDKernel,
}


def create_kernel(cfg: dict) -> Kernel:
    """The kernel named by a config's first key ("SE" and "kernel_res" are
    the scalar SE kernel)."""
    name = next(iter(cfg))
    if name in ("SE", "kernel_res"):
        return SquaredExponentialKernel()
    if name in KERNEL_REGISTRY:
        return KERNEL_REGISTRY[name]()
    raise KeyError(f"unknown kernel {name!r}")


class _Legacy:
    """Shared state: the merged config, device and cached training data."""

    default_config: dict = {}

    def __init__(self, config: Optional[dict], device):
        self.config = update_dict_with_default(self.default_config, config or {})
        self.device = resolve_device(device)
        self.train_x = None
        self.train_y = None

    def _cache(self, x, y, update_data):
        x, y = _f32(x, self.device), _f32(y, self.device)
        if self.train_x is None or update_data:
            self.train_x, self.train_y = x, y
        return x, y


class LegacyCIGP(_Legacy):
    """Config-driven CIGP."""

    default_config = {
        "noise": {"init_value": 1.0},
        "kernel": {"SE": {"length_scale": 1.0, "scale": 1.0}},
        "input_dim": 1,
    }

    def __init__(self, config: Optional[dict] = None, device="cuda"):
        super().__init__(config, device)
        cfg = self.config
        self.core = CIGPCore(kernel=create_kernel(cfg["kernel"]))
        self.params = self.core.init_params(
            cfg["input_dim"], log_beta=float(cfg["noise"]["init_value"]), device=self.device)

    def compute_loss(self, x, y, x_var=0.0, y_var=0.0, update_data=False):
        x, y = self._cache(x, y, update_data)
        yv = None if np.isscalar(y_var) and y_var == 0.0 else _f32(y_var, self.device)
        return self.core.nll(self.params, x, y, y_var=yv)

    def forward(self, x, x_var=0.0):
        """Posterior mean ``(m, d)`` and DIAGONAL variance ``(m, 1)``."""
        if self.train_x is None:
            raise RuntimeError("compute_loss must cache training data first")
        with torch.no_grad():
            mean, var = self.core.predict_diag(self.params, self.train_x, self.train_y,
                                               _f32(x, self.device))
        return mean, var.reshape(-1, 1)

    def fit(self, x, y, max_iter=100, lr=5e-2):
        """Adam on the cached data (not in the legacy API); returns the loss
        history."""
        self.compute_loss(x, y, update_data=True)
        res = fit(self.core.nll, self.params, steps=max_iter, lr=lr,
                  loss_args=(self.train_x, self.train_y))
        self.params = res.params
        return res.losses


class LegacyHOGP(_Legacy):
    """Config-driven HOGP; `forward` predicts from the posterior state of
    the last `compute_loss` (or `fit`), made anew if there is none."""

    default_config = {
        "noise": {"init_value": 1.0},
        "kernel": {"SE": {}},
        "input_dim": 1,
        "output_shape": (4, 4),
    }

    def __init__(self, config: Optional[dict] = None, device="cuda"):
        super().__init__(config, device)
        cfg = self.config
        if int(np.prod(cfg["output_shape"])) == 1:
            import warnings

            warnings.warn("HOGP with scalar outputs; use CIGP instead")
        self.core = HOGPCore(kernel=create_kernel(cfg["kernel"]),
                             output_shape=tuple(cfg["output_shape"]))
        self.params = self.core.init_params(
            cfg["input_dim"], noise_variance=float(cfg["noise"]["init_value"]),
            device=self.device)
        self._state = None

    def compute_loss(self, x, y, x_var=0.0, y_var=0.0, update_data=False):
        x, y = self._cache(x, y, update_data)
        loss, self._state = self.core.nll_with_state(self.params, x, y)
        return loss

    def forward(self, x, x_var=0.0):
        """Posterior mean and diagonal variance, ``(m, *output_shape)``."""
        with torch.no_grad():
            if self._state is None:
                _, self._state = self.core.nll_with_state(self.params, self.train_x,
                                                          self.train_y)
            return self.core.predict(self.params, self._state, self.train_x,
                                     _f32(x, self.device))

    def fit(self, x, y, max_iter=100, lr=5e-2):
        self.compute_loss(x, y, update_data=True)
        res = fit(self.core.nll, self.params, steps=max_iter, lr=lr,
                  loss_args=(self.train_x, self.train_y))
        self.params = res.params
        with torch.no_grad():
            _, self._state = self.core.nll_with_state(self.params, self.train_x, self.train_y)
        return res.losses


class LegacyFIDES(_Legacy):
    """Config-driven FIDES; `set_fidelity` gives the two fidelity intervals
    before any loss or prediction."""

    default_config = {
        "noise": {"init_value": 1.0, "format": "exp"},
        "kernel": {"kernel_res": {}},
        "input_dim": 1,
    }

    def __init__(self, config: Optional[dict] = None, device="cuda"):
        super().__init__(config, device)
        self.core = FIDESCore()
        self.params = self.core.init_params(self.config["input_dim"], device=self.device)
        self.bounds = None

    def set_fidelity(self, l1, h1, l2, h2):
        self.bounds = FidelityBounds(float(l1), float(h1), float(l2), float(h2))

    def _require_bounds(self):
        # AssertionError, as the legacy contract's callers expect
        if self.bounds is None:
            raise AssertionError("call set_fidelity first")

    def compute_loss(self, x, y, x_var=0.0, y_var=0.0, update_data=False):
        self._require_bounds()
        x, y = self._cache(x, y, update_data)
        return self.core.nll(self.params, x, y, self.bounds)

    def forward(self, x, x_var=0.0):
        """Posterior mean and diagonal variance, ``(m, 1)`` each."""
        self._require_bounds()
        if self.train_x is None:
            raise RuntimeError("compute_loss must cache training data first")
        with torch.no_grad():
            return self.core.predict(self.params, self.train_x, self.train_y,
                                     _f32(x, self.device), self.bounds)

    def fit(self, x, y, max_iter=100, lr=5e-2):
        self.compute_loss(x, y, update_data=True)
        res = fit(self.core.nll, self.params, steps=max_iter, lr=lr,
                  loss_args=(self.train_x, self.train_y, self.bounds))
        self.params = res.params
        return res.losses
