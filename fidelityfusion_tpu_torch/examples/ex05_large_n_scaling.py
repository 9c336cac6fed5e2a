"""Example 5: the large-n toolbox - what to reach for when n grows.

Port of `examples/05_large_n_scaling.py`, its six parts:

  1. the analytic-gradient SE NLML (`ops/fused_se.py`), which CIGP takes
     for the scalar SE kernel from 512 rows (K1, then K2 + K3b);
  2. the tracked-spectrum HOGP (`models/hogp.py:nll_tracked`): mode 0's
     eigenbasis warm-started and refined by Jacobi sweeps between
     scheduled ``eigh`` refreshes;
  3. n-axis sharding (`parallel/nsharded.py:fit_nsharded`): the training
     set's rows sharded over the ranks (distributed Gram and blocked
     Cholesky, all-reduced NLML and gradient);
  4. the sharded Kronecker/HOGP path (`parallel/kron_nsharded.py`);
  5. restarts x n (`fit_restarts_nsharded`);
  6. the one-call cascade: ``train_AR(..., n_mesh=...)`` routes stages of
     at least ``nshard_min_rows`` rows (2048 by default) through the
     sharded path.

A single process runs the sharded parts over a world of one rank (started
for it); a world of several, each rank running this script, shards them:

    python -m fidelityfusion_tpu_torch.examples.ex05_large_n_scaling [--cpu] [--n 1024]
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="run on the CPU (default: cuda)")
    parser.add_argument("--n", type=int, default=512,
                        help="training rows (use 1024/4096 on a card)")
    args = parser.parse_args(argv)

    import torch

    from fidelityfusion_tpu_torch.models.ar import AR, train_AR
    from fidelityfusion_tpu_torch.models.cigp import CIGP
    from fidelityfusion_tpu_torch.models.data_manager import MultiFidelityDataManager
    from fidelityfusion_tpu_torch.models.hogp import HOGP
    from fidelityfusion_tpu_torch.ops.kernels import ARDKernel, SquaredExponentialKernel
    from fidelityfusion_tpu_torch.parallel import (
        fit_hogp_nsharded, fit_nsharded, fit_restarts_nsharded, make_n_mesh)
    from fidelityfusion_tpu_torch.parallel.mesh import axis_size
    from fidelityfusion_tpu_torch.train.fit import adam_scan, adam_scan_aux, perturb_params
    from fidelityfusion_tpu_torch.utils.device import resolve_device, synced_time

    device = resolve_device("cpu" if args.cpu else "cuda")
    n = args.n
    rng = np.random.default_rng(0)
    print(f"device: {device}  n={n}")
    out = {}

    # --- 1. single-fidelity CIGP at large n: the se-analytic path
    x = torch.tensor((rng.random((n, 1)) * 10).astype(np.float32), device=device)
    y = torch.sin(x)
    gp = CIGP(kernel=SquaredExponentialKernel())  # se-analytic from 512 rows
    t0 = synced_time(device)
    _, _, losses = adam_scan(lambda p: gp.nll(p, x, y), gp.init_params(1, device=device),
                             5e-2, 60)
    out["cigp"] = losses
    print(f"[1] CIGP se-analytic n={n}: 60 steps in {synced_time(device) - t0:.1f}s, "
          f"NLML {float(losses[0]):.2f} -> {float(losses[-1]):.2f}")

    # --- 2. HOGP tensor outputs with the tracked spectrum
    shape = (16, 16)
    yt = torch.tensor(
        (np.sin(x.cpu().numpy())[:, :, None]
         * np.outer(np.linspace(0, 1, shape[0]), np.linspace(0, 1, shape[1]))[None]
         + 0.05 * rng.standard_normal((n,) + shape)).astype(np.float32), device=device)
    hogp = HOGP(kernel=SquaredExponentialKernel(), output_shape=shape)
    hp0 = hogp.init_params(1, device=device)
    t0 = synced_time(device)
    _, _, hlosses, (_, max_res) = adam_scan_aux(
        lambda p, aux, step: hogp.nll_tracked(p, aux, step, x, yt), hp0,
        hogp.tracking_aux0(n, device=device), 1e-2, 60)
    out["hogp"] = hlosses
    print(f"[2] HOGP tracked n={n} {shape}: 60 steps in {synced_time(device) - t0:.1f}s, "
          f"NLML {float(hlosses[0]):.3f} -> {float(hlosses[-1]):.3f}, "
          f"max tracking residual {float(max_res):.4f}")

    # --- 3. n-axis sharded training over the ranks
    mesh = make_n_mesh(device=device)  # every rank of the world on the "n" dim
    P = axis_size(mesh, "n")
    gp2 = CIGP(kernel=ARDKernel())
    t0 = synced_time(device)
    _, losses2 = fit_nsharded(gp2, gp2.init_params(1, device=device), x, y, mesh, steps=60,
                              lr=5e-2)
    out["nsharded"] = losses2
    print(f"[3] n-sharded over {P} rank(s): 60 steps in {synced_time(device) - t0:.1f}s, "
          f"NLML {float(losses2[0]):.2f} -> {float(losses2[-1]):.2f}")

    # --- 4. distributed Kronecker/HOGP training: the tracked step's n^3
    # products sharded over the ranks (pure tracking: one eigh at step 0)
    t0 = synced_time(device)
    _, klosses, _ = fit_hogp_nsharded(hogp, hp0, x, yt, mesh, steps=30, lr=1e-2)
    out["kron_nsharded"] = klosses
    print(f"[4] Kronecker n-sharded over {P} rank(s): 30 steps in "
          f"{synced_time(device) - t0:.1f}s, NLML {float(klosses[0]):.3f} -> "
          f"{float(klosses[-1]):.3f}")

    # --- 5. restarts x n: the restart ladder and the distributed
    # factorization on one mesh
    batch = perturb_params(torch.Generator().manual_seed(0), gp2.init_params(1, device=device),
                           n=4)
    t0 = synced_time(device)
    _, final_rn = fit_restarts_nsharded(gp2, batch, x, y, mesh, steps=30, lr=5e-2)
    out["restarts_nsharded"] = final_rn
    print(f"[5] restarts x n (R=4): 30 steps in {synced_time(device) - t0:.1f}s, "
          f"best final NLML {float(final_rn.min()):.2f}")

    # --- 6. one-call cascade training with n-sharded stages: train_AR
    # routes stages of >= nshard_min_rows rows (2048 by default) through
    # the distributed path; here every stage, on 2-fidelity toy data
    xh = x[: n // 2]
    dm = MultiFidelityDataManager([
        {"raw_fidelity_name": "0", "fidelity_indicator": 0, "X": x.cpu().numpy(),
         "Y": (torch.sin(x) - 0.3 * torch.sin(2 * x)).cpu().numpy()},
        {"raw_fidelity_name": "1", "fidelity_indicator": 1, "X": xh.cpu().numpy(),
         "Y": torch.sin(xh).cpu().numpy()}])
    model = AR(2, [SquaredExponentialKernel()] * 2, input_dim=1, device=device)
    t0 = synced_time(device)
    train_AR(model, dm, max_iter=60, lr_init=5e-2, n_mesh=mesh, nshard_min_rows=1)
    x_test = np.linspace(0, 10, 100, dtype=np.float32)[:, None]
    mean, _ = model.forward(dm, x_test)
    rmse = float(np.sqrt(np.mean((mean.detach().cpu().numpy() - np.sin(x_test)) ** 2)))
    out["ar_rmse"] = rmse
    print(f"[6] train_AR with n_mesh ({P} rank(s), every stage sharded): "
          f"{synced_time(device) - t0:.1f}s, test RMSE {rmse:.4f}")
    print("done - PERF.md holds the measured numbers")
    return out


if __name__ == "__main__":
    main()
