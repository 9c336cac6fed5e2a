"""Example 1: multi-fidelity regression with every fusion model.

Port of `examples/01_multifidelity_regression.py` (the reference's
per-model demos, `FidelityFusion_Models/*.py` __main__ blocks, in one
script): AR, ResGP and NAR on the canonical 3-fidelity toy sin.

    python -m fidelityfusion_tpu_torch.examples.ex01_multifidelity_regression [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--iters", type=int, default=300, help="Adam steps per stage")
    args = parser.parse_args(argv)

    from fidelityfusion_tpu_torch.experiments.metrics import calculate_metrix
    from fidelityfusion_tpu_torch.models.ar import AR, train_AR
    from fidelityfusion_tpu_torch.models.data_manager import MultiFidelityDataManager
    from fidelityfusion_tpu_torch.models.nar import NAR, train_NAR
    from fidelityfusion_tpu_torch.models.resgp import ResGP, train_ResGP
    from fidelityfusion_tpu_torch.ops.kernels import SquaredExponentialKernel
    from fidelityfusion_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    # --- the canonical 3-fidelity toy sin problem
    rng = np.random.default_rng(1)
    x_all = rng.random((500, 1)) * 20
    pick = lambda n: x_all[np.sort(rng.permutation(500)[:n])]  # noqa: E731
    xs = [pick(300), pick(300), pick(250)]
    noise = lambda n: rng.random((n, 1)) * 0.1 - 0.05  # noqa: E731
    ys = [
        np.sin(xs[0]) - 0.5 * np.sin(2 * xs[0]) + noise(300),
        np.sin(xs[1]) - 0.3 * np.sin(2 * xs[1]) + noise(300),
        np.sin(xs[2]) + noise(250),
    ]
    x_test = np.linspace(0, 20, 100).reshape(-1, 1)
    y_test = np.sin(x_test)

    dm = MultiFidelityDataManager([
        {"raw_fidelity_name": str(i), "fidelity_indicator": i, "X": x, "Y": y}
        for i, (x, y) in enumerate(zip(xs, ys))])

    out = {}
    for name, cls, train in [("AR", AR, train_AR), ("ResGP", ResGP, train_ResGP),
                             ("NAR", NAR, train_NAR)]:
        model = cls(3, [SquaredExponentialKernel() for _ in range(3)], input_dim=1,
                    device=device)
        train(model, dm, max_iter=args.iters, lr_init=5e-2)
        mean, cov = model(dm, x_test)
        var = np.diagonal(cov.detach().cpu().numpy())
        out[name] = calculate_metrix(y_test, mean.detach().cpu().numpy(), var)
        print(name, out[name])
    return out


if __name__ == "__main__":
    main()
