"""Continuous-fidelity Bayesian optimization: the outer loop.

Port of `fidelityfusion_tpu/bo/continuous_loop.py`: a FIDES surrogate over
(x, z in [z_min, 1]) trained by `train/fit.py:fit` (K1, K2, K3b each
step), a continuous-fidelity acquisition (UCB with the information-gap z
rule, ES or best-observed KG, `bo/continuous.py`), the objective queried
at (x, z), and the record of cost and incumbent.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from fidelityfusion_tpu_torch.bo.continuous import (
    ContinuousFidelityES,
    ContinuousFidelityUCB,
    continuous_best_observed_kg,
)
from fidelityfusion_tpu_torch.data.cost import ContinuousCost
from fidelityfusion_tpu_torch.models.fides import FIDES, FidelityBounds
from fidelityfusion_tpu_torch.train.fit import fit
from fidelityfusion_tpu_torch.utils.device import resolve_device, synced_time


def mf_bo_continuous(objective, method: str = "UCB", bo_iterations: int = 10, n_init: int = 8,
                     seed: int = 0, train_iters: int = 150, train_lr: float = 5e-2,
                     z_min: float = 0.1, verbose: bool = False, init_data=None, cost=None,
                     device="cuda") -> Dict:
    """``objective`` follows the continuous protocol (`data/objectives.py:
    Branin`, `Hartmann3`): ``get_data(x, z)``, ``initiate_data(num, seed) ->
    (x, y, z)``.  ``method``: "UCB", "ES" (cost-aware max-value entropy
    search; the last iteration cashes in at the top-fidelity posterior
    argmax) or "KG" (best-observed knowledge gradient).  ``init_data``:
    optional (x, y, z) initial arrays; ``cost`` defaults to
    `ContinuousCost(rate=2.0)`.  Returns the record {cost, incumbents,
    operation_time, train_time, acq_time, X, Z}."""
    device = resolve_device(device)
    if init_data is not None:
        x, y, z = (np.asarray(a, np.float64).reshape(len(init_data[0]), -1) for a in init_data)
    else:
        x, y, z = objective.initiate_data(n_init, seed)
    cost = cost or ContinuousCost(rate=2.0, s_min=z_min, s_max=1.0)
    d = objective.x_dim
    srange = list(objective.search_range[:d]) + [[z_min, 1.0]]
    bounds_f = FidelityBounds(z_min, 1.0, z_min, 1.0)
    fides = FIDES()
    record = {"cost": [], "incumbents": [], "operation_time": [], "train_time": [],
              "acq_time": [], "X": [], "Z": []}

    for it in range(bo_iterations):
        t0 = synced_time(device)
        # the surrogate over the joint (x, z) input, y standardized
        ym, ys = float(y.mean()), float(y.std() + 1e-9)
        xj = torch.as_tensor(np.concatenate([x, z], axis=1).astype(np.float32), device=device)
        yj = torch.as_tensor(((y - ym) / ys).astype(np.float32), device=device)
        res = fit(lambda p: fides.nll(p, xj, yj, bounds_f),
                  fides.init_params(xj.shape[1], device=device), steps=train_iters,
                  lr=train_lr)
        t1 = synced_time(device)

        def posterior_fn(x_in, z_val, params=res.params, xj=xj, yj=yj):
            x_in = torch.atleast_2d(torch.as_tensor(x_in, dtype=torch.float32, device=device))
            xq = torch.cat([x_in, torch.full((x_in.shape[0], 1), float(z_val), device=device)],
                           dim=1)
            return fides.predict(params, xj, yj, xq, bounds_f)

        is_last = it == bo_iterations - 1
        if method == "UCB":
            strategy = ContinuousFidelityUCB(d, srange, posterior_fn, cost, seed=seed + it,
                                             device=device)
            new_x, new_z = strategy.compute_next(steps=30, lr=0.05)
        elif method == "ES":
            strategy = ContinuousFidelityES(d, srange, posterior_fn, cost, seed=seed + it,
                                            maximize=True, device=device)
            if is_last:
                # final budget iteration: cash in at the expected-best (x, z = 1)
                with torch.no_grad():
                    mu, _ = posterior_fn(strategy.xs, 1.0)
                j = int(torch.argmax(mu.reshape(-1)))
                new_x, new_z = strategy.xs[j].reshape(1, -1), 1.0
            else:
                new_x, new_z = strategy.compute_next()
        elif method == "KG":
            def mean_cov_fn(xz, params=res.params, xj=xj, yj=yj):
                mu_n, cov = fides.predict_full(params, xj, yj, xz, bounds_f)
                return mu_n * ys + ym, cov * ys ** 2  # raw y units

            new_x, new_z = continuous_best_observed_kg(
                mean_cov_fn, srange, cost, incumbent=float(np.max(y)), seed=seed + 7 * it,
                is_last=is_last, device=device)
        else:
            raise ValueError(method)
        t2 = synced_time(device)
        new_y = objective.get_data(new_x, new_z)

        x = np.concatenate([x, new_x], axis=0)
        y = np.concatenate([y, new_y.reshape(1, -1)], axis=0)
        z = np.concatenate([z, np.full((1, 1), new_z)], axis=0)

        record["X"].append(np.asarray(new_x).ravel().tolist())
        record["Z"].append(float(new_z))
        record["cost"].append(float(np.sum(cost.compute_cost(z))))
        record["incumbents"].append(float(np.max(y)))
        record["operation_time"].append(time.time() - t0)
        record["train_time"].append(t1 - t0)
        record["acq_time"].append(t2 - t1)
        if verbose:
            print(f"iter {it}: z={new_z:.2f} incumbent={record['incumbents'][-1]:.4f}")
    return record
