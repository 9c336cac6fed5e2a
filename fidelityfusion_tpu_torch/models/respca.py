"""ResPCA: PCA-family dimensionality reduction for high-dimensional outputs.

Port of `fidelityfusion_tpu/models/respca.py`: energy-rank-truncated SVD
bases (`torch.linalg.svd`) for flattened field outputs, in four variants:

  * `PCA`       one basis over one dataset;
  * `ListPCA`   an independent basis per fidelity;
  * `ResPCA`    the lowest fidelity's basis plus a residual basis per
                higher fidelity;
  * `ResPCAMF`  residual bases over fidelities with different sample
                counts (each residual on the samples shared with the
                fidelity below).

The rank is the smallest that captures ``energy`` of the total variance.
No kernel: the SVD and the products are library calls.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from fidelityfusion_tpu_torch.utils.device import resolve_device


def _energy_rank(s: torch.Tensor, energy: float) -> int:
    e = np.cumsum(s.cpu().numpy() ** 2)
    e = e / e[-1]
    return int(np.searchsorted(e, energy) + 1)


def _flat(y, device) -> torch.Tensor:
    y = y if torch.is_tensor(y) else torch.as_tensor(np.asarray(y))
    return y.to(device=device, dtype=torch.float32).reshape(len(y), -1)


class PCA:
    """Mean-centered truncated-SVD basis: y (n, D) <-> z (n, r)."""

    def __init__(self, y, energy: float = 0.99, rank: int = None, device="cuda"):
        self.device = resolve_device(device)
        y = _flat(y, self.device)
        self.mean = y.mean(0, keepdim=True)
        _, s, vt = torch.linalg.svd(y - self.mean, full_matrices=False)
        self.rank = rank if rank is not None else _energy_rank(s, energy)
        self.basis = vt[:self.rank]  # (r, D)

    def project(self, y) -> torch.Tensor:
        return (_flat(y, self.device) - self.mean) @ self.basis.T

    def recover(self, z) -> torch.Tensor:
        return z @ self.basis + self.mean


class ListPCA:
    """Independent PCA per fidelity."""

    def __init__(self, y_list: Sequence, energy: float = 0.99, device="cuda"):
        self.pcas = [PCA(y, energy, device=device) for y in y_list]

    def project(self, y_list: Sequence) -> List[torch.Tensor]:
        return [p.project(y) for p, y in zip(self.pcas, y_list)]

    def recover(self, z_list: Sequence) -> List[torch.Tensor]:
        return [p.recover(z) for p, z in zip(self.pcas, z_list)]


class ResPCA:
    """The lowest fidelity's basis plus per-fidelity residual bases: a
    higher fidelity's y is encoded as (z_base, z_residual), the residual
    being y - recover(base_project(y))."""

    def __init__(self, y_list: Sequence, energy: float = 0.99, device="cuda"):
        self.base = PCA(y_list[0], energy, device=device)
        self.res_pcas = [PCA(self._residual(y), energy, device=device) for y in y_list[1:]]

    def _residual(self, y) -> torch.Tensor:
        return _flat(y, self.base.device) - self.base.recover(self.base.project(y))

    def project(self, y_list: Sequence):
        out = [self.base.project(y_list[0])]
        for y, rp in zip(y_list[1:], self.res_pcas):
            out.append(torch.cat([self.base.project(y), rp.project(self._residual(y))], dim=1))
        return out

    def recover(self, z_list: Sequence):
        out = [self.base.recover(z_list[0])]
        rb = self.base.rank
        for z, rp in zip(z_list[1:], self.res_pcas):
            out.append(self.base.recover(z[:, :rb]) + rp.recover(z[:, rb:]))
        return out


class ResPCAMF:
    """Residual PCA over fidelities with different sample counts: fidelity
    i's residual basis is fitted on the first min(n_i, n_{i-1}) samples it
    shares with fidelity i - 1."""

    def __init__(self, y_list: Sequence, energy: float = 0.99, device="cuda"):
        self.base = PCA(y_list[0], energy, device=device)
        self.res_pcas = [PCA(r, energy, device=device) for r in self._residuals(y_list)]

    def _residuals(self, y_list: Sequence) -> List[torch.Tensor]:
        prev = _flat(y_list[0], self.base.device)
        out = []
        for y in y_list[1:]:
            y_flat = _flat(y, self.base.device)
            n = min(len(prev), len(y_flat))
            out.append(y_flat[:n] - prev[:n])
            prev = y_flat
        return out

    def project_residuals(self, y_list: Sequence):
        return [self.base.project(y_list[0])] + [
            rp.project(r) for rp, r in zip(self.res_pcas, self._residuals(y_list))]
