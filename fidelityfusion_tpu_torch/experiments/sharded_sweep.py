"""Seed sweeps sharded over ranks: the seed axis runs data-parallel.

Port of `fidelityfusion_tpu/experiments/sharded_sweep.py`: the seeds of
one (AR, dataset, n_high) cell are split over the ranks of a mesh, each
rank trains and predicts its seeds, and the metric rows come back in the
seeds' order.  The JAX package vmaps the seeds into one program; here a
rank loops over its seeds, since each seed has its own x and K1 shares x
across its batch.  Restricted to the 2-fidelity subset AR protocol; the
general harness (`experiments/sweep.py`) covers everything else serially.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from fidelityfusion_tpu_torch.experiments.load_mfdata import load_data
from fidelityfusion_tpu_torch.experiments.metrics import calculate_metrix
from fidelityfusion_tpu_torch.models.cigp import CIGP
from fidelityfusion_tpu_torch.ops.kernels import SquaredExponentialKernel
from fidelityfusion_tpu_torch.parallel.collectives import all_gather_rows
from fidelityfusion_tpu_torch.parallel.mesh import axis_index, axis_size, make_mesh
from fidelityfusion_tpu_torch.train.fit import adam_scan


def _ar_train_predict(gp: CIGP, steps: int, lr: float):
    """One complete 2-fidelity AR run (train the low GP, train the residual
    GP and rho, predict the cascade) as a function of one seed's data."""

    def train_last_good(loss_fn, p0):
        # the last params whose loss was verified finite
        _, good_p, losses = adam_scan(loss_fn, p0, lr, steps)
        return good_p, losses

    def run(data):
        xl, yl, xh, yl_at_xh, yh, xt = (data[k] for k in ("xl", "yl", "xh", "yl_at_xh",
                                                          "yh", "xt"))
        p_low, _ = train_last_good(lambda p: gp.nll(p, xl, yl), data["p_low"])
        p_res, _ = train_last_good(lambda pr: gp.nll(pr["gp"], xh, yh - pr["rho"] * yl_at_xh),
                                   {"gp": data["p_res"], "rho": data["rho"]})
        with torch.no_grad():
            mean_l, var_l = gp.predict_diag(p_low, xl, yl, xt)
            mean_r, var_r = gp.predict_diag(p_res["gp"], xh, yh - p_res["rho"] * yl_at_xh, xt)
            rho = p_res["rho"]
            return rho * mean_l + mean_r, rho ** 2 * var_l + var_r

    return run


def _seed_data(dataset, seed, n_low, n_high, n_test):
    """(normalized float32 training arrays, input dim, y_test, (y_high mean,
    std)) of one seed, as the JAX harness builds them."""
    d = load_data(dataset, n_train_low=n_low, n_train_high=n_high, n_test=n_test, seed=seed,
                  subset=True)
    xl, yl = d["x_low"], d["y_low"]
    xm, xs = xl.mean(0), xl.std(0) + 1e-10
    ym, ys = yl.mean(), yl.std() + 1e-10
    yhm, yhs = d["y_high"].mean(), d["y_high"].std() + 1e-10
    # low-fidelity y at the high-fidelity x (subset: an exact lookup)
    lookup = {tuple(r): i for i, r in enumerate(map(tuple, xl))}
    yl_at_xh = np.stack([yl[lookup[tuple(r)]] for r in map(tuple, d["x_high"])])
    arrays = {"xl": (xl - xm) / xs, "yl": (yl - ym) / ys, "xh": (d["x_high"] - xm) / xs,
              "yl_at_xh": (yl_at_xh - ym) / ys, "yh": (d["y_high"] - yhm) / yhs,
              "xt": (d["x_test"] - xm) / xs}
    arrays = {k: np.asarray(v, np.float32) for k, v in arrays.items()}
    return arrays, d["x_dim"], d["y_test"], (yhm, yhs)


def run_sharded_seed_sweep(dataset: str, seeds: Sequence[int], n_high: int = 16,
                           n_low: int = 64, n_test: int = 64, steps: int = 200,
                           lr: float = 5e-2, mesh=None, device="cuda") -> List[Dict[str, float]]:
    """Train AR for every seed, the seeds split over the ranks of ``mesh``
    (1-D, dim "restart"; by default `make_mesh` over the world on
    ``device``, a world of one process if none exists).  Returns one metric
    row per seed, in the seeds' order (r2 / rmse / nll / nrmse, seed,
    dataset, n_high), the same on every rank: the protocol of
    `experiments/sweep.py:run_single(method='AR')` with the normalization
    folded into the data build."""
    gp = CIGP(kernel=SquaredExponentialKernel(), se_analytic_nll=False)
    if mesh is None:
        mesh = make_mesh(device=device)
    dev = torch.device(mesh.device_type)
    P, me = axis_size(mesh, "restart"), axis_index(mesh, "restart")
    seeds = list(seeds)
    built = [_seed_data(dataset, s, n_low, n_high, n_test) for s in seeds]
    per = -(-len(seeds) // P)
    order = list(range(len(seeds)))
    mine = (order + order[-1:] * (per * P - len(seeds)))[me * per:(me + 1) * per]
    run = _ar_train_predict(gp, steps, lr)
    outs = []
    for i in mine:
        arrays, x_dim = built[i][:2]
        data = {k: torch.tensor(v, device=dev) for k, v in arrays.items()}
        data.update(p_low=gp.init_params(x_dim, device=dev),
                    p_res=gp.init_params(x_dim, device=dev), rho=torch.tensor(1.0, device=dev))
        outs.append(run(data))
    group = mesh.get_group("restart")
    means = all_gather_rows(torch.stack([m.reshape(-1) for m, _ in outs]), group)
    vars_ = all_gather_rows(torch.stack([v.reshape(-1) for _, v in outs]), group)
    rows = []
    for i, seed in enumerate(seeds):
        _, _, truth, (yhm, yhs) = built[i]
        mean = means[i].cpu().numpy()[:, None] * yhs + yhm
        var = vars_[i].cpu().numpy() * yhs ** 2
        row = calculate_metrix(truth, mean, var)
        row.update({"seed": seed, "dataset": dataset, "n_high": n_high})
        rows.append(row)
    return rows
