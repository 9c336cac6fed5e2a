"""Legacy subset-detection API + tensor-list normalization manager.

Port of `fidelityfusion_tpu/utils/subset_tools.py` (numpy): the same call
surface over the port's native/numpy row matching.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from fidelityfusion_tpu_torch.models.data_manager import Normalizer, match_rows


def _np(a) -> np.ndarray:
    return np.asarray(a, np.float64)


class SubsetChecker:
    """`Subset_checker` (`subset_tools.py:44-110`)."""

    @staticmethod
    def get_subset(x1, x2) -> Tuple[np.ndarray, np.ndarray]:
        """Indices (into x1 and x2) of rows of x1 that also appear in x2."""
        x1, x2 = _np(x1), _np(x2)
        m1, m2 = match_rows(x1, x2)
        idx1 = np.where(m1)[0]
        # for each matched x1 row, its first matching index in x2
        idx2 = []
        for i in idx1:
            hits = np.where((x2 == x1[i]).all(axis=1))[0]
            idx2.append(hits[0])
        return idx1, np.asarray(idx2, int)

    @staticmethod
    def get_non_subset(x1, x2) -> np.ndarray:
        """Indices of rows of x1 absent from x2 (`subset_tools.py:92-110`)."""
        m1, _ = match_rows(_np(x1), _np(x2))
        return np.where(~m1)[0]

    @staticmethod
    def self_test(seed: int = 0, n: int = 50, d: int = 3) -> bool:
        """The reference's shuffle self-check (`subset_tools.py:112-136`)."""
        rng = np.random.default_rng(seed)
        base = rng.random((n, d))
        perm = rng.permutation(n)[: n // 2]
        sub = base[perm]
        idx1, idx2 = SubsetChecker.get_subset(base, sub)
        ok = np.allclose(np.sort(base[idx1], axis=0), np.sort(sub[idx2], axis=0))
        return bool(ok and len(idx1) == len(sub))


class DatasetNormalizeManager:
    """Per-tensor-list input/output normalizers
    (`Dateset_normalize_manager`, `normalizer.py:23-77`)."""

    def __init__(self, x_list: Sequence, y_list: Sequence):
        self.x_norms = [Normalizer(x, np.zeros((len(x), 1))) for x in x_list]
        self.y_norms = [Normalizer(np.zeros((len(y), 1)), y) for y in y_list]

    def normalize_all(self, x_list, y_list):
        xs = [n.normalize_x(x) for n, x in zip(self.x_norms, x_list)]
        ys = [n.normalize_y(y) for n, y in zip(self.y_norms, y_list)]
        return xs, ys

    def denormalize_output(self, i: int, mean, var):
        return self.y_norms[i].denormalize(mean, var)


class Normalize0Layer:
    """Whole-tensor standardization with inverse
    (`GaussianProcess/gp_transform.py:14-30` `Normalize0_layer`)."""

    def __init__(self, data):
        data = np.asarray(data, np.float64)
        self.mean = data.mean()
        self.std = data.std(ddof=1) + 1e-10

    def forward(self, x):
        return (np.asarray(x) - self.mean) / self.std

    def inverse(self, x):
        return np.asarray(x) * self.std + self.mean

    def inverse_var(self, var):
        """Covariance transform (`gp_transform.py:44-62`)."""
        return np.asarray(var) * self.std**2


class NormalizeLayer:
    """Per-dimension standardization with inverse
    (`GaussianProcess/gp_transform.py:25-35` `Normalize_layer`)."""

    def __init__(self, data, dim: int = 0):
        data = np.asarray(data, np.float64)
        self.mean = data.mean(axis=dim)
        self.std = data.std(axis=dim, ddof=1) + 1e-10

    def forward(self, x):
        return (np.asarray(x) - self.mean) / self.std

    def inverse(self, x):
        return np.asarray(x) * self.std + self.mean


class Normalize0DistributionLayer(Normalize0Layer):
    """Whole-tensor standardization that also transforms the covariance
    (`gp_transform.py:38-47` `Normalize0_DistributionLayer`): a scalar
    scale acts on Sigma as Sigma/std^2 (forward) / Sigma*std^2 (inverse)."""

    def forward(self, x, Sigma=0):
        return super().forward(x), np.asarray(Sigma) / self.std**2

    def inverse(self, x, Sigma=0):
        return super().inverse(x), np.asarray(Sigma) * self.std**2


class NormalizeDistributionLayer(NormalizeLayer):
    """Per-dimension standardization transforming a full covariance matrix
    (`gp_transform.py:49-62` `Normalize_DistributionLayer`):
    Sigma' = D^{-1} Sigma D^{-1} with D = diag(std) (forward), and
    Sigma' = D Sigma D (inverse)."""

    def forward(self, x, Sigma=0):
        mean = super().forward(x)
        inv = (1.0 / self.std).reshape(-1, 1)
        return mean, inv * np.asarray(Sigma) * inv.T

    def inverse(self, x, Sigma=0):
        mean = super().inverse(x)
        s = self.std.reshape(-1, 1)
        return mean, s * np.asarray(Sigma) * s.T
