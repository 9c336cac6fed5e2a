"""Evaluation metrics: r2 / rmse / nll / nrmse.

Port of `fidelityfusion_tpu/experiments/metrics.py`: pure numpy functions
over host arrays (move device tensors to the CPU first).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def r2(actual: np.ndarray, predict: np.ndarray) -> float:
    actual = np.asarray(actual, float).ravel()
    predict = np.asarray(predict, float).ravel()
    ss_res = np.sum((actual - predict) ** 2)
    ss_tot = np.sum((actual - actual.mean()) ** 2)
    return float(1.0 - ss_res / ss_tot) if ss_tot > 0 else 0.0

def rmse(actual: np.ndarray, predict: np.ndarray) -> float:
    a = np.asarray(actual, float).ravel()
    p = np.asarray(predict, float).ravel()
    return float(np.sqrt(np.mean((a - p) ** 2)))


def nrmse(actual: np.ndarray, predict: np.ndarray) -> float:
    """Mean squared error over the target range (`calculate_metrix.py:20-23`:
    ``avg((a-p)^2) / (max - min)``)."""
    a = np.asarray(actual, float).ravel()
    p = np.asarray(predict, float).ravel()
    rng = a.max() - a.min()
    return float(np.mean((a - p) ** 2) / rng) if rng > 0 else float("inf")


def gaussian_nll(actual: np.ndarray, predict_mean: np.ndarray, predict_var: np.ndarray,
                 eps: float = 1e-6) -> float:
    """Mean per-point Gaussian NLL with diagonal predictive variance
    (`torch.nn.functional.gaussian_nll_loss` semantics used at
    `calculate_metrix.py:43`)."""
    a = np.asarray(actual, float).ravel()
    m = np.asarray(predict_mean, float).ravel()
    v = np.maximum(np.asarray(predict_var, float).ravel(), eps)
    return float(np.mean(0.5 * (np.log(v) + (a - m) ** 2 / v)))


def calculate_metrix(
    actual: np.ndarray, predict_mean: np.ndarray, predict_var: np.ndarray
) -> Dict[str, float]:
    """All four metrics as a dict (`calculate_metrix.py:26-47`)."""
    return {
        "r2": r2(actual, predict_mean),
        "rmse": rmse(actual, predict_mean),
        "nll": gaussian_nll(actual, predict_mean, predict_var),
        "nrmse": nrmse(actual, predict_mean),
    }
