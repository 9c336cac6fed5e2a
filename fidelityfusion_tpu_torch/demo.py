"""CLI demo: train the AR cascade end to end on the 3-fidelity toy sin.

Port of `fidelityfusion_tpu/demo.py` for the ``AR`` model (the other
models are not ported yet):

    python -m fidelityfusion_tpu_torch.demo AR [--nonsubset] [--device cpu]

Runs on the card by default; ``--device cpu`` runs the plain PyTorch
versions of the kernels.  Prints r2 / rmse / nll / nrmse against sin(x).
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def _toy_3fid(seed=1, nonsubset=False, sizes=(300, 300, 250), pool=500,
              n_test=100, nested=False):
    """The seeded 3-fidelity toy sin: y_f(x) = sin(x) - c_f sin(2x) + U(-0.05,
    0.05) on x in [0, 20].  Subset designs draw each fidelity's rows from
    one pool of ``pool`` points, independently or (``nested``) as prefixes
    of one permutation, so each fidelity's rows contain the next one's;
    ``nonsubset`` draws the inputs themselves independently.  With the
    defaults this is `fidelityfusion_tpu/demo.py:_toy_3fid`."""
    rng = np.random.default_rng(seed)
    if nonsubset:
        xs = [np.sort(rng.random((n, 1)) * 20, axis=0) for n in sizes]
    elif nested:
        x_all = rng.random((pool, 1)) * 20
        perm = rng.permutation(pool)
        xs = [x_all[np.sort(perm[:n])] for n in sizes]
    else:
        x_all = rng.random((pool, 1)) * 20
        xs = [x_all[np.sort(rng.permutation(pool)[:n])] for n in sizes]
    noise = lambda n: rng.random((n, 1)) * 0.1 - 0.05  # noqa: E731
    ys = [
        np.sin(xs[0]) - 0.5 * np.sin(2 * xs[0]) + noise(len(xs[0])),
        np.sin(xs[1]) - 0.3 * np.sin(2 * xs[1]) + noise(len(xs[1])),
        np.sin(xs[2]) + noise(len(xs[2])),
    ]
    x_test = np.linspace(0, 20, n_test).reshape(-1, 1)
    return xs, ys, x_test, np.sin(x_test)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("model", choices=["AR"])
    parser.add_argument("--iters", type=int, default=200)
    parser.add_argument("--lr", type=float, default=5e-2)
    parser.add_argument("--restarts", type=int, default=4)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--nonsubset", action="store_true",
                        help="non-nested fidelity designs + imputation training")
    args = parser.parse_args(argv)

    from fidelityfusion_tpu_torch.experiments.metrics import calculate_metrix
    from fidelityfusion_tpu_torch.models.ar import AR, train_AR
    from fidelityfusion_tpu_torch.models.data_manager import MultiFidelityDataManager
    from fidelityfusion_tpu_torch.ops.kernels import SquaredExponentialKernel

    t0 = time.time()
    xs, ys, x_test, y_test = _toy_3fid(nonsubset=args.nonsubset)
    dm = MultiFidelityDataManager([
        {"raw_fidelity_name": str(i), "fidelity_indicator": i, "X": x, "Y": y}
        for i, (x, y) in enumerate(zip(xs, ys))
    ])
    model = AR(3, [SquaredExponentialKernel() for _ in range(3)], input_dim=1,
               if_nonsubset=args.nonsubset, device=args.device)
    train_AR(model, dm, max_iter=args.iters, lr_init=args.lr, n_restarts=args.restarts)
    mean, cov = model.forward(dm, x_test)
    m = calculate_metrix(y_test, mean.detach().cpu().numpy(),
                         np.diagonal(cov.detach().cpu().numpy()))
    m = {k: round(float(v), 5) for k, v in m.items()}
    print(f"{args.model}: {m} ({time.time() - t0:.1f}s)")
    return m


if __name__ == "__main__":
    main()
