"""CLI demo: train a model end to end on the 3-fidelity toy sin.

Port of `fidelityfusion_tpu/demo.py` for the vector models (GAR, HOGP and
CIGAR are not ported yet):

    python -m fidelityfusion_tpu_torch.demo MODEL [--nonsubset] [--device cpu]

MODEL in {AR, NAR, ResGP, CAR, CAR_large, CIGP, FIDES}.  The cascades
train on the three fidelities; CIGP and FIDES fit the top fidelity alone.
``--nonsubset`` (AR, NAR, ResGP) draws each fidelity's inputs
independently and trains through the imputation path.  Runs on the card
by default; ``--device cpu`` runs the plain PyTorch versions of the
kernels.  Prints r2 / rmse / nll / nrmse against sin(x).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def _toy_3fid(seed=1, nonsubset=False, sizes=(300, 300, 250), pool=500,
              n_test=100, nested=False):
    """The seeded 3-fidelity toy sin: y_f(x) = sin(x) - c_f sin(2x) + U(-0.05,
    0.05) on x in [0, 20].  Subset designs draw each fidelity's rows from
    one pool of ``pool`` points, independently or (``nested``) as prefixes
    of one permutation, so each fidelity's rows contain the next one's;
    ``nonsubset`` draws the inputs themselves independently.  With the
    defaults, and ``sizes=(300, 200, 150)`` for ``nonsubset``, this is
    `fidelityfusion_tpu/demo.py:_toy_3fid`."""
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
    parser.add_argument("model", choices=["AR", "NAR", "ResGP", "CAR", "CAR_large", "CIGP",
                                          "FIDES"])
    parser.add_argument("--iters", type=int, default=200)
    parser.add_argument("--lr", type=float, default=5e-2)
    parser.add_argument("--restarts", type=int, default=4)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--nonsubset", action="store_true",
                        help="non-nested fidelity designs + imputation training "
                             "(AR/NAR/ResGP)")
    args = parser.parse_args(argv)
    name = args.model
    if args.nonsubset and name not in ("AR", "NAR", "ResGP"):
        parser.error("--nonsubset supports AR/NAR/ResGP")

    from fidelityfusion_tpu_torch.experiments.metrics import calculate_metrix
    from fidelityfusion_tpu_torch.utils.device import resolve_device

    t0 = time.time()
    device = resolve_device(args.device)
    sizes = (300, 200, 150) if args.nonsubset else (300, 300, 250)
    xs, ys, x_test, y_test = _toy_3fid(nonsubset=args.nonsubset, sizes=sizes)
    if name in ("CIGP", "FIDES"):
        mean, var = _single_fidelity(name, xs[-1], ys[-1], x_test, args, device)
    else:
        mean, var = _cascade(name, xs, ys, x_test, args, device)
    m = calculate_metrix(y_test, mean, var)
    m = {k: round(float(v), 5) for k, v in m.items()}
    print(f"{name}: {m} ({time.time() - t0:.1f}s)")
    return m


def _cascade(name, xs, ys, x_test, args, device):
    """Train a 3-fidelity cascade on the toy sin; raw-space (mean, var)."""
    from fidelityfusion_tpu_torch.models.ar import AR, train_AR
    from fidelityfusion_tpu_torch.models.car import (
        ContinuousAutoRegression, ContinuousAutoRegressionLarge, train_CAR, train_CAR_large)
    from fidelityfusion_tpu_torch.models.data_manager import MultiFidelityDataManager
    from fidelityfusion_tpu_torch.models.nar import NAR, train_NAR
    from fidelityfusion_tpu_torch.models.resgp import ResGP, train_ResGP
    from fidelityfusion_tpu_torch.ops.kernels import ARDKernel, SquaredExponentialKernel

    dm = MultiFidelityDataManager([
        {"raw_fidelity_name": str(i), "fidelity_indicator": i, "X": x, "Y": y}
        for i, (x, y) in enumerate(zip(xs, ys))
    ])
    kernels = [SquaredExponentialKernel() for _ in range(3)]
    fit_args = dict(max_iter=args.iters, lr_init=args.lr)
    cascades = {"AR": (AR, train_AR), "NAR": (NAR, train_NAR), "ResGP": (ResGP, train_ResGP)}
    if name in cascades:
        cls, train = cascades[name]
        model = cls(3, kernels, input_dim=1, if_nonsubset=args.nonsubset, device=device)
        train(model, dm, n_restarts=args.restarts, **fit_args)
    elif name == "CAR":
        model = ContinuousAutoRegression(3, [ARDKernel()] * 3, input_dim=1, device=device)
        train_CAR(model, dm, n_restarts=args.restarts, **fit_args)
    else:  # CAR_large
        model = ContinuousAutoRegressionLarge(3, ARDKernel(), input_dim=1, device=device)
        train_CAR_large(model, dm, **fit_args)
    mean, cov = model.forward(dm, x_test)
    return mean.detach().cpu().numpy(), np.diagonal(cov.detach().cpu().numpy())


def _single_fidelity(name, x, y, x_test, args, device):
    """Fit one GP (CIGP, or FIDES at bounds (0, 1, 0, 1)) to the top
    fidelity, standardized; raw-space (mean, var)."""
    from fidelityfusion_tpu_torch.models.cigp import CIGP
    from fidelityfusion_tpu_torch.models.fides import FIDES, FidelityBounds
    from fidelityfusion_tpu_torch.ops.kernels import SquaredExponentialKernel
    from fidelityfusion_tpu_torch.train.fit import fit

    xm, xsd, ym, ysd = x.mean(), x.std(), y.mean(), y.std()
    as_t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    xn, yn, xt = as_t((x - xm) / xsd), as_t((y - ym) / ysd), as_t((x_test - xm) / xsd)
    if name == "CIGP":
        gp = CIGP(kernel=SquaredExponentialKernel())
        res = fit(gp.nll, gp.init_params(1, device=device), steps=args.iters, lr=args.lr,
                  loss_args=(xn, yn))
        mean, cov = gp.predict(res.params, xn, yn, xt)
        var = cov.diagonal()
    else:
        fides, bounds = FIDES(), FidelityBounds(0.0, 1.0, 0.0, 1.0)
        res = fit(fides.nll, fides.init_params(1, device=device), steps=args.iters,
                  lr=args.lr, loss_args=(xn, yn, bounds))
        mean, var = fides.predict(res.params, xn, yn, xt, bounds)
    mean = mean.detach().cpu().numpy() * ysd + ym
    return mean, var.detach().cpu().numpy().ravel() * ysd ** 2


if __name__ == "__main__":
    main()
