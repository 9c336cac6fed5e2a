"""Experiment sweep harness: models x datasets x seeds x train sizes -> CSV.

Port of `fidelityfusion_tpu/experiments/sweep.py` (re-design of the
reference sweep scripts `Experiments/GAR_Non_Aligned/exp_non_aligned.py:
43-123`, `Experiments/CAR_Subset/exp_car.py:18-77`): run a grid of
(method, dataset, seed, n_high) configurations, record
r2/rmse/nll/nrmse/time rows, and write
``<outdir>/<dataset>/<method>_seed_<s>.csv`` exactly as the JAX harness
and the reference do, so `experiments/plots.py` reads the files of
either.

Every cell trains on ``device`` (default ``"cuda"``; ``"cpu"`` runs the
plain PyTorch versions) through the port's trainers; ``time`` is the wall
of training plus the test forward, read after a synchronize.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Sequence

import numpy as np
import torch

from fidelityfusion_tpu_torch.experiments.load_mfdata import load_data
from fidelityfusion_tpu_torch.experiments.metrics import calculate_metrix
from fidelityfusion_tpu_torch.models.ar import AR, train_AR
from fidelityfusion_tpu_torch.models.car import ContinuousAutoRegression, train_CAR
from fidelityfusion_tpu_torch.models.cigar import CIGAR, train_CIGAR
from fidelityfusion_tpu_torch.models.data_manager import MultiFidelityDataManager
from fidelityfusion_tpu_torch.models.gar import GAR, train_GAR
from fidelityfusion_tpu_torch.models.nar import NAR, train_NAR
from fidelityfusion_tpu_torch.models.resgp import ResGP, train_ResGP
from fidelityfusion_tpu_torch.ops.kernels import ARDKernel, SquaredExponentialKernel
from fidelityfusion_tpu_torch.utils.device import resolve_device, synced_time

MODEL_REGISTRY = {
    "AR": (AR, train_AR),
    "NAR": (NAR, train_NAR),
    "ResGP": (ResGP, train_ResGP),
    "CAR": (ContinuousAutoRegression, train_CAR),
    "GAR": (GAR, train_GAR),
    "CIGAR": (CIGAR, train_CIGAR),
}

# methods constructed with an explicit per-fidelity output-shape list
# (the reference passes data_shape_list, `exp_non_aligned.py:95-96`)
_SHAPED_METHODS = ("GAR", "CIGAR")

# the reference's CSV columns (`exp_non_aligned.py:53`)
GRID_COLUMNS = ["train_sample_num", "rmse", "nrmse", "r2", "nll", "time"]
COST_COLUMNS = ["cost", "rmse", "r2", "nll", "nrmse", "time"]


def _build_model(method, y_low, y_high, subset, input_dim, device="cuda"):
    """Instantiate a registry model the way the reference sweep scripts do
    (`exp_non_aligned.py:93-98`): AR-family takes (fidelity_num, kernels),
    GAR/CIGAR additionally take the per-fidelity output shapes."""
    cls, train_fn = MODEL_REGISTRY[method]
    if method == "CAR":
        model = cls(2, [ARDKernel() for _ in range(2)], input_dim=input_dim,
                    if_nonsubset=not subset, device=device)
    elif method in _SHAPED_METHODS:
        shapes = [np.asarray(y_low).shape[1:] or (1,), np.asarray(y_high).shape[1:] or (1,)]
        model = cls(2, [SquaredExponentialKernel() for _ in range(2)],
                    data_shape_list=shapes, if_nonsubset=not subset, input_dim=input_dim,
                    device=device)
    else:
        model = cls(2, [SquaredExponentialKernel() for _ in range(2)],
                    if_nonsubset=not subset, input_dim=input_dim, device=device)
    return model, train_fn


def _two_fidelity_manager(x_low, y_low, x_high, y_high) -> MultiFidelityDataManager:
    return MultiFidelityDataManager([
        {"raw_fidelity_name": "0", "fidelity_indicator": 0, "X": x_low, "Y": y_low},
        {"raw_fidelity_name": "1", "fidelity_indicator": 1, "X": x_high, "Y": y_high},
    ])


def _train_and_score(method, x_low, y_low, x_high, y_high, x_test, y_test, subset,
                     input_dim, max_iter, lr, n_restarts, device) -> Dict[str, float]:
    """One cell: build, train and predict on ``device``, then the metric
    row {r2, rmse, nll, nrmse, time} from the host copies of the outputs."""
    dm = _two_fidelity_manager(x_low, y_low, x_high, y_high)
    model, train_fn = _build_model(method, y_low, y_high, subset, input_dim, device)
    xt = torch.as_tensor(np.asarray(x_test, np.float32), device=device)
    t0 = synced_time(device)
    train_fn(model, dm, max_iter=max_iter, lr_init=lr, n_restarts=n_restarts)
    with torch.no_grad():
        mean, cov = model.forward(dm, xt)
    elapsed = synced_time(device) - t0
    row = calculate_metrix(y_test, mean.cpu().numpy(), _pred_var(method, cov.cpu().numpy()))
    row["time"] = elapsed
    return row


def run_single(
    method: str,
    dataset: str,
    seed: int,
    n_high: int,
    n_low: int = 100,
    n_test: int = 100,
    subset: bool = True,
    max_iter: int = 200,
    lr: float = 5e-2,
    n_restarts: int = 4,
    device="cuda",
) -> Dict[str, float]:
    """Train one (method, dataset, seed, n_high) cell on ``device`` and
    return the metric row {r2, rmse, nll, nrmse, time} (reference row
    format, `exp_non_aligned.py:110-116`)."""
    device = resolve_device(device)
    data = load_data(dataset, n_train_low=n_low, n_train_high=n_high, n_test=n_test,
                     seed=seed, subset=subset)
    return _train_and_score(method, data["x_low"], data["y_low"], data["x_high"],
                            data["y_high"], data["x_test"], data["y_test"], subset,
                            data["x_dim"], max_iter, lr, n_restarts, device)


def _pred_var(method: str, cov) -> np.ndarray:
    """Per-point predictive variance from a model's second output: the AR
    family returns a full test covariance (diagonal wanted); GAR/CIGAR
    return per-element variance tensors (used as-is, the reference's
    `diag_embed(flatten(var))` detour, `exp_non_aligned.py:106-107`)."""
    cov = np.asarray(cov)
    if method in _SHAPED_METHODS:
        return cov.reshape(cov.shape[0], -1)
    return np.diagonal(cov) if cov.ndim == 2 else cov


def run_sweep(
    methods: Sequence[str],
    datasets: Sequence[str],
    seeds: Sequence[int] = (0, 1, 2, 3, 4),
    n_high_grid: Sequence[int] = (4, 8, 16, 32),
    outdir: str = "exp_results",
    **kwargs,
) -> List[Dict]:
    """The reference grid protocol: per (dataset, method, seed) write one
    CSV with a row per n_high (`exp_non_aligned.py:47-123`).  ``kwargs``
    go to `run_single` (``device`` among them)."""
    rows = []
    for dataset in datasets:
        for method in methods:
            for seed in seeds:
                records = []
                for n_high in n_high_grid:
                    row = run_single(method, dataset, seed, n_high, **kwargs)
                    row.update({"method": method, "dataset": dataset, "seed": seed,
                                "n_high": n_high, "train_sample_num": n_high})
                    records.append(row)
                    rows.append(row)
                _write_csv(os.path.join(outdir, dataset), f"{method}_seed_{seed}.csv", records)
    return rows


def _write_csv(dirpath: str, filename: str, records: List[Dict],
               fieldnames: Sequence[str] = GRID_COLUMNS) -> str:
    """One reference-format CSV (`exp_non_aligned.py:53,118-123`): columns
    train_sample_num,rmse,nrmse,r2,nll,time (the cost protocol's:
    cost,rmse,r2,nll,nrmse,time)."""
    os.makedirs(dirpath, exist_ok=True)
    path = os.path.join(dirpath, filename)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(fieldnames), extrasaction="ignore")
        w.writeheader()
        w.writerows(records)
    return path


def _car_fixture(rng, n_low: int, n_high: int, subset: bool):
    """The CAR papers' noisy-sin fixture (`Experiments/CAR_Subset/exp_car.py:28-42`,
    `CAR_Cost/exp_car.py:36-50`): x ~ U[0,20], y_low = sin(x) - U*0.2,
    y_high = sin(x) - U*0.1; subset mode draws hi-fid x as a subset of the
    lo-fid rows, cost mode draws them independently."""
    x_all = (rng.random((500, 1)) * 20).astype(np.float32)
    x_low = np.sort(x_all[rng.permutation(500)[:n_low]], axis=0)
    if subset:
        x_high = np.sort(x_low[rng.permutation(n_low)[:n_high]], axis=0)
    else:
        x_high = np.sort(x_all[rng.permutation(500)[:n_high]], axis=0)
    y_low = np.sin(x_low) - rng.random((n_low, 1)).astype(np.float32) * 0.2
    y_high = np.sin(x_high) - rng.random((n_high, 1)).astype(np.float32) * 0.1
    x_test = np.linspace(0, 20, 100, dtype=np.float32).reshape(-1, 1)
    return x_low, y_low, x_high, y_high, x_test, np.sin(x_test)


def _car_cell(method, x_low, y_low, x_high, y_high, x_test, y_test,
              subset, max_iter, lr, n_restarts, device="cuda"):
    return _train_and_score(method, x_low, y_low, x_high, y_high, x_test, y_test, subset, 1,
                            max_iter, lr, n_restarts, resolve_device(device))


def run_car_sweep(
    methods: Sequence[str] = ("CAR",),
    seeds: Sequence[int] = (0, 1),
    train_sizes: Sequence[int] = (32, 64, 96, 128),
    dec_rate: float = 0.75,
    outdir: str = "exp_results",
    dataset_name: str = "sample_data",
    max_iter: int = 100,
    lr: float = 1e-2,
    n_restarts: int = 4,
    device="cuda",
) -> List[Dict]:
    """The CAR-paper train-size protocol (`Experiments/CAR_Subset/exp_car.py`):
    per (method, seed) sweep the lo-fid train size; the hi-fid set is a
    ``dec_rate`` fraction subset.  Writes
    ``<outdir>/<dataset>/car_<dec_rate>_seed_<s>.csv``."""
    device = resolve_device(device)
    rows = []
    for method in methods:
        for seed in seeds:
            rng = np.random.default_rng(seed)
            records = []
            for n in train_sizes:
                fixture = _car_fixture(rng, n, int(dec_rate * n), subset=True)
                row = _car_cell(method, *fixture, subset=True, max_iter=max_iter, lr=lr,
                                n_restarts=n_restarts, device=device)
                row.update({"train_sample_num": n, "method": method, "seed": seed})
                records.append(row)
                rows.append(row)
            _write_csv(os.path.join(outdir, dataset_name),
                       f"{method.lower()}_{dec_rate}_seed_{seed}.csv", records)
    return rows


def run_car_cost_sweep(
    methods: Sequence[str] = ("CAR",),
    start_seeds: Sequence[int] = (1,),
    n_cells: int = 5,
    outdir: str = "exp_results",
    dataset_name: str = "sample_data",
    max_iter: int = 100,
    lr: float = 1e-2,
    n_restarts: int = 4,
    device="cuda",
) -> List[Dict]:
    """The CAR-paper cost protocol (`Experiments/CAR_Cost/exp_car.py`):
    random (n_low, n_high) cells, non-nested designs, cost = n_high;
    writes ``<outdir>/<dataset>/car_seed_<start>.csv`` with a cost column."""
    device = resolve_device(device)
    rows = []
    for method in methods:
        for start in start_seeds:
            records = []
            for seed in range(start, start + n_cells):
                rng = np.random.default_rng(seed)
                n_low = int(rng.integers(64, 128))
                n_high = n_low - int(rng.integers(0, 64))
                fixture = _car_fixture(rng, n_low, n_high, subset=False)
                row = _car_cell(method, *fixture, subset=False, max_iter=max_iter, lr=lr,
                                n_restarts=n_restarts, device=device)
                row.update({"cost": n_high, "method": method, "seed": seed})
                records.append(row)
                rows.append(row)
            _write_csv(os.path.join(outdir, dataset_name), f"{method.lower()}_seed_{start}.csv",
                       records, COST_COLUMNS)
    return rows


def _upsample_fields(fields: np.ndarray, r_hi: int) -> np.ndarray:
    """Bilinear upsample (n, r, r) interior-grid fields to (n, r_hi, r_hi).

    Interior grid coords are (i+1)/(r+1); the interpolation matrix M maps
    coarse->fine per axis, applied as M @ F @ M.T."""
    r_lo = fields.shape[-1]
    g_lo = (np.arange(1, r_lo + 1)) / (r_lo + 1)
    g_hi = (np.arange(1, r_hi + 1)) / (r_hi + 1)
    M = np.zeros((r_hi, r_lo), np.float64)
    for i, t in enumerate(g_hi):
        j = np.clip(np.searchsorted(g_lo, t) - 1, 0, r_lo - 2)
        w = (t - g_lo[j]) / (g_lo[j + 1] - g_lo[j])
        w = np.clip(w, 0.0, 1.0)
        M[i, j], M[i, j + 1] = 1.0 - w, w
    return np.einsum("ab,nbc,dc->nad", M, fields.astype(np.float64), M).astype(np.float32)


def _field_fixture(
    dataset: str,
    seed: int,
    n_low: int,
    n_high: int,
    n_test: int,
    variant: str,
    resolutions=(8, 16),
):
    """Two-fidelity PDE tensor-field problem (the GAR-paper data class,
    fields from `data/pde.py`).

    variant:
      * 'non-aligned' — coarse (r0, r0) vs fine (r1, r1) output grids,
        hi-fid x nested in lo-fid x (`exp_non_aligned.py:59-62` sampling);
      * 'aligned'     — both fidelities on the fine grid (low = coarse
        solve bilinearly upsampled: real fidelity bias, equal shapes);
      * 'non-subset'  — non-aligned grids, hi-fid x drawn independently
        (`exp_non_subset.py:78` / `generate_nonsubset_data`).
    """
    from fidelityfusion_tpu_torch.data import pde

    solver = pde.poisson_fields if dataset == "poisson" else pde.heat_fields
    rng = np.random.default_rng(seed)
    d_in = 4
    x_low = rng.random((n_low, d_in)).astype(np.float32)
    if variant == "non-subset":
        x_high = rng.random((n_high, d_in)).astype(np.float32)
    else:
        x_high = x_low[:n_high]
    x_test = rng.random((n_test, d_in)).astype(np.float32)

    y_low_all = solver(np.concatenate([x_low, x_test]), resolutions[:1])[0]
    y_hi_all = solver(np.concatenate([x_high, x_test]), resolutions[1:2])[0]
    y_low = y_low_all[:n_low]
    y_high, y_test = y_hi_all[:n_high], y_hi_all[n_high:]
    if variant == "aligned":
        y_low = _upsample_fields(y_low, resolutions[1])
    return x_low, y_low, x_high, y_high, x_test, y_test


def run_gar_field_sweep(
    methods: Sequence[str] = ("GAR", "CIGAR"),
    datasets: Sequence[str] = ("poisson",),
    seeds: Sequence[int] = (0, 1, 2, 3, 4),
    n_high_grid: Sequence[int] = (4, 8, 16, 32),
    variant: str = "non-aligned",
    n_low: int = 100,
    n_test: int = 100,
    resolutions=(8, 16),
    outdir: str = "exp_results",
    max_iter: int = 100,
    lr: float = 5e-2,
    n_restarts: int = 4,
    device="cuda",
) -> List[Dict]:
    """The GAR-paper sweep protocols on tensor-field data
    (`Experiments/GAR_Aligned/exp_aligned.py`, `GAR_Non_Aligned/
    exp_non_aligned.py:43-123`, `GAR_Non_Subset/exp_non_subset.py`):
    method x dataset x seed {0-4} x n_high {4,8,16,32}, rmse/nrmse/r2/
    nll/time rows to ``<outdir>/<dataset>_<variant>/<method>_seed_<s>.csv``
    in the reference CSV format."""
    device = resolve_device(device)
    rows = []
    subset = variant != "non-subset"
    for dataset in datasets:
        for method in methods:
            for seed in seeds:
                records = []
                for n_high in n_high_grid:
                    x_low, y_low, x_high, y_high, x_test, y_test = _field_fixture(
                        dataset, seed, n_low, n_high, n_test, variant, resolutions)
                    row = _train_and_score(method, x_low, y_low, x_high, y_high, x_test,
                                           y_test, subset, x_low.shape[1], max_iter, lr,
                                           n_restarts, device)
                    row.update({"method": method, "dataset": dataset, "seed": seed,
                                "n_high": n_high, "train_sample_num": n_high,
                                "variant": variant})
                    records.append(row)
                    rows.append(row)
                _write_csv(os.path.join(outdir, f"{dataset}_{variant}"),
                           f"{method}_seed_{seed}.csv", records)
    return rows


def main(argv=None):
    """CLI: reproduce the reference sweep protocols.

    python -m fidelityfusion_tpu_torch.experiments.sweep \
        --methods AR ResGP --datasets tl112 forrester14 --seeds 0 1 \
        --n-high 4 8 16 32 --outdir exp_results

    ``--protocol car`` runs the CAR train-size sweep; ``--protocol
    car-cost`` the CAR cost sweep (both on the papers' noisy-sin fixture);
    ``--protocol gar-field`` the tensor-field sweep.  Cells train on
    ``--device`` (default ``cuda``, which raises without a GPU; pass
    ``--device cpu`` for the plain PyTorch versions).
    """
    import argparse

    parser = argparse.ArgumentParser(description=main.__doc__)
    parser.add_argument("--protocol", default="grid",
                        choices=["grid", "car", "car-cost", "gar-field"])
    parser.add_argument("--variant", default="non-aligned",
                        choices=["aligned", "non-aligned", "non-subset"],
                        help="gar-field sampling variant")
    parser.add_argument("--resolutions", nargs=2, type=int, default=[8, 16])
    parser.add_argument("--n-restarts", type=int, default=4)
    parser.add_argument("--methods", nargs="+", default=["AR", "ResGP", "NAR"])
    parser.add_argument("--datasets", nargs="+", default=["tl112"])
    parser.add_argument("--seeds", nargs="+", type=int, default=[0, 1, 2, 3, 4])
    parser.add_argument("--n-high", nargs="+", type=int, default=[4, 8, 16, 32])
    parser.add_argument("--train-sizes", nargs="+", type=int, default=[32, 64, 96, 128])
    parser.add_argument("--dec-rate", type=float, default=0.75)
    parser.add_argument("--n-low", type=int, default=100)
    parser.add_argument("--n-test", type=int, default=100)
    parser.add_argument("--nonsubset", action="store_true")
    parser.add_argument("--max-iter", type=int, default=200)
    parser.add_argument("--outdir", default="exp_results")
    parser.add_argument("--device", default="cuda",
                        help="torch device of every cell (cuda or cpu)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    default_methods = args.methods == ["AR", "ResGP", "NAR"]
    if args.protocol == "gar-field":
        rows = run_gar_field_sweep(
            methods=("GAR", "CIGAR") if default_methods else args.methods,
            datasets=("poisson",) if args.datasets == ["tl112"] else args.datasets,
            seeds=args.seeds, n_high_grid=args.n_high, variant=args.variant,
            n_low=args.n_low, n_test=args.n_test, resolutions=tuple(args.resolutions),
            outdir=args.outdir, max_iter=args.max_iter, n_restarts=args.n_restarts,
            device=device)
    elif args.protocol == "car":
        rows = run_car_sweep(
            methods=("CAR",) if default_methods else args.methods, seeds=args.seeds,
            train_sizes=args.train_sizes, dec_rate=args.dec_rate, outdir=args.outdir,
            max_iter=args.max_iter, device=device)
    elif args.protocol == "car-cost":
        rows = run_car_cost_sweep(
            methods=("CAR",) if default_methods else args.methods, start_seeds=args.seeds,
            outdir=args.outdir, max_iter=args.max_iter, device=device)
    else:
        rows = run_sweep(
            methods=args.methods, datasets=args.datasets, seeds=args.seeds,
            n_high_grid=args.n_high, outdir=args.outdir, n_low=args.n_low,
            n_test=args.n_test, subset=not args.nonsubset, max_iter=args.max_iter,
            device=device)
    print(f"wrote {len(rows)} rows under {args.outdir}/")
    return rows


if __name__ == "__main__":
    main()
