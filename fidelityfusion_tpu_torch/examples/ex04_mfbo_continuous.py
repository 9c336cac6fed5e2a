"""Example 4: continuous-fidelity Bayesian optimization on Branin.

Port of `examples/04_mfbo_continuous.py`
(`Experiments/MFBO_continuous/MF_BO_continuous.py:20-100`: a FIDES
surrogate over the joint (x, z) input, fidelity z in [0.1, 1]):

    python -m fidelityfusion_tpu_torch.examples.ex04_mfbo_continuous [--device cpu]

Also demonstrates the per-strategy continuous acquisitions
(`bo/continuous.py`: UCB with the information-gap fidelity rule, ES).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--iterations", type=int, default=5)
    args = parser.parse_args(argv)

    import torch

    from fidelityfusion_tpu_torch.bo.continuous import (
        ContinuousFidelityES, ContinuousFidelityUCB)
    from fidelityfusion_tpu_torch.bo.continuous_loop import mf_bo_continuous
    from fidelityfusion_tpu_torch.data.cost import ContinuousCost
    from fidelityfusion_tpu_torch.data.objectives import Branin
    from fidelityfusion_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    # --- the full loop (FIDES surrogate rebuilt every iteration)
    record = mf_bo_continuous(Branin(), bo_iterations=args.iterations, n_init=8, seed=0,
                              verbose=True, device=device)
    print("incumbents:", [round(v, 3) for v in record["incumbents"]])
    print("queried fidelities:", [round(z, 2) for z in record["Z"]])

    # --- standalone strategy objects over a posterior closure
    def posterior(x, z):
        mean = -torch.sum((x - 0.5) ** 2, dim=-1)
        var = torch.ones(x.shape[0], device=x.device) * (0.3 * (1.1 - float(z)))
        return mean, var

    search_range = [[0.0, 1.0], [0.0, 1.0], [0.1, 1.0]]
    ucb = ContinuousFidelityUCB(2, search_range, posterior, ContinuousCost(), seed=0,
                                device=device)
    x_u, z_u = ucb.compute_next(torch.Generator().manual_seed(0))
    print(f"UCB next: x={x_u.ravel()}, z={z_u:.2f}")

    es = ContinuousFidelityES(2, search_range, posterior, ContinuousCost(), n_candidates=32,
                              n_mc=64, device=device)
    x_e, z_e = es.compute_next()
    print(f"ES next:  x={x_e.ravel()}, z={z_e:.2f}")
    return record


if __name__ == "__main__":
    main()
