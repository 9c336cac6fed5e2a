"""Cross-fidelity coupling: per-output-mode linear lifts.

Port of `fidelityfusion_tpu/models/coupling.py`.  `TensorLinear` lifts a
low-fidelity tensor field onto the high-fidelity grid by one trainable
linear map per output mode, initialized as a linear-interpolation
identity, and accumulates the mode products over every mode (the
reference applied only the last one).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from fidelityfusion_tpu_torch.ops.kron import mode_dot
from fidelityfusion_tpu_torch.utils.device import resolve_device


def interp_identity(l_dim: int, h_dim: int) -> np.ndarray:
    """(l_dim, h_dim) linear-interpolation matrix mapping a length-l_dim
    signal onto a length-h_dim grid; the identity when they match."""
    if l_dim == h_dim:
        return np.eye(l_dim, dtype=np.float32)
    pos = np.linspace(0, l_dim - 1, h_dim)
    lo = np.floor(pos).astype(int)
    hi = np.minimum(lo + 1, l_dim - 1)
    w = (pos - lo).astype(np.float32)
    M = np.zeros((l_dim, h_dim), dtype=np.float32)
    M[lo, np.arange(h_dim)] += 1.0 - w
    M[hi, np.arange(h_dim)] += w
    return M


@dataclasses.dataclass(frozen=True)
class TensorLinear:
    """Trainable per-mode linear lift from ``l_shape`` to ``h_shape``."""

    l_shape: Tuple[int, ...]
    h_shape: Tuple[int, ...]

    def init_params(self, device="cuda"):
        device = resolve_device(device)
        return {"maps": [torch.tensor(interp_identity(l, h), device=device)
                         for l, h in zip(self.l_shape, self.h_shape)]}

    def apply(self, params, x: torch.Tensor) -> torch.Tensor:
        """``(n, l_1..l_M) -> (n, h_1..h_M)``.  With maps ``(R, l, h)`` (a
        restart batch) the input is ``(n, ...)`` shared or ``(R, n, ...)``
        and the output ``(R, n, h_1..h_M)``."""
        maps = params["maps"]
        off = 1
        if maps[0].ndim == 3:
            off = 2
            if x.ndim == len(self.l_shape) + 1:
                x = x[None]
        y = x
        for m, M in enumerate(maps):
            y = mode_dot(y, M.transpose(-1, -2), m + off)
        return y

    __call__ = apply
