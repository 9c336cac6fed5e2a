"""CLI demo: train a model end to end.

Port of `fidelityfusion_tpu/demo.py`:

    python -m fidelityfusion_tpu_torch.demo MODEL [--nonsubset] [--device cpu]

MODEL in {AR, NAR, ResGP, CAR, CAR_large, CIGP, FIDES, GAR, HOGP, CIGAR}.
The vector models run on the 3-fidelity toy sin: the cascades train on
the three fidelities, CIGP and FIDES fit the top fidelity alone, and
``--nonsubset`` (AR, NAR, ResGP) draws each fidelity's inputs
independently and trains through the imputation path.  GAR, HOGP and
CIGAR run on 64 Poisson source fields (`data/pde.py`, resolutions (8, 12,
16), d_in = 4), 48 training rows: GAR and CIGAR over the three
fidelities, HOGP on the top one.  Runs on the card by default; ``--device
cpu`` runs the plain PyTorch versions of the kernels.  Prints r2 / rmse /
nll / nrmse on the held-out rows.
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
                                          "FIDES", "GAR", "HOGP", "CIGAR"])
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
    if name in ("GAR", "HOGP", "CIGAR"):
        y_test, mean, var = _field(name, args, device)
    else:
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


def _field(name, args, device, n_tr=48):
    """Train GAR or CIGAR on three Poisson fidelities, or HOGP on the top
    one (standardized), over the first ``n_tr`` samples; (test fields of
    the top fidelity, raw-space mean, variance)."""
    from fidelityfusion_tpu_torch.data.pde import generate_poisson_mf_dataset
    from fidelityfusion_tpu_torch.models.data_manager import MultiFidelityDataManager
    from fidelityfusion_tpu_torch.ops.kernels import ARDKernel

    x, ys = generate_poisson_mf_dataset(n_samples=64, resolutions=(8, 12, 16), d_in=4, seed=0)
    if name == "HOGP":
        from fidelityfusion_tpu_torch.models.hogp import HOGP
        from fidelityfusion_tpu_torch.train.fit import fit

        y = ys[-1]
        ym, ysd, xm, xsd = y.mean(), y.std(), x.mean(0), x.std(0)
        as_t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
        xn, yn = as_t((x - xm) / xsd), as_t((y - ym) / ysd)
        hogp = HOGP(kernel=ARDKernel(), output_shape=y.shape[1:])
        res = fit(hogp.nll, hogp.init_params(x.shape[1], device=device), steps=args.iters,
                  lr=args.lr, loss_args=(xn[:n_tr], yn[:n_tr]))
        with torch.no_grad():
            _, state = hogp.nll_with_state(res.params, xn[:n_tr], yn[:n_tr])
            mean, var = hogp.predict(res.params, state, xn[:n_tr], xn[n_tr:])
        return (y[n_tr:], mean.cpu().numpy() * ysd + ym, var.cpu().numpy() * ysd ** 2)
    from fidelityfusion_tpu_torch.models.cigar import CIGAR, train_CIGAR
    from fidelityfusion_tpu_torch.models.gar import GAR, train_GAR

    shapes = [f.shape[1:] for f in ys]
    ys_use = [f.reshape(len(f), -1) for f in ys] if name == "CIGAR" else ys
    dm = MultiFidelityDataManager([
        {"raw_fidelity_name": str(i), "fidelity_indicator": i, "X": x[:n_tr], "Y": y[:n_tr]}
        for i, y in enumerate(ys_use)])
    cls, train = (GAR, train_GAR) if name == "GAR" else (CIGAR, train_CIGAR)
    model = cls(3, [ARDKernel()] * 3, shapes, input_dim=x.shape[1], device=device)
    train(model, dm, max_iter=args.iters, lr_init=args.lr, n_restarts=args.restarts)
    with torch.no_grad():
        mean, var = model.forward(dm, x[n_tr:])
    return ys_use[-1][n_tr:], mean.cpu().numpy(), var.cpu().numpy()


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
