#!/usr/bin/env python3
"""Whole GAR fits of the benchmark's `gar.fit-poisson-2048` cell with the
mode Grams through K5 and through ``torch.linalg.eigh``, in turns in one
process.

    python3 scripts/time_gar_eigh_routes.py [--pairs 8] [--seed N]

`ops/kron.py:eigh_pairs` takes K5 (`kron.small_eigh`) for CUDA Grams of
up to `SMALL_EIGH_MAX_N` rows; with `kron.small_eigh` swapped for
`kron.eigh_plain` every Gram takes ``torch.linalg.eigh`` as before K5.  After the cell's own set-up
(`portbench/drivers/fit_gar.py`), the script runs ``--pairs`` pairs of fits
(`train_GAR` and `GAR.forward`, each fit's initial parameters from the seed
and its index, the same for both routes), the order alternating (library,
K5, K5, library, ...), so that both routes see the host as it drifts.
Prints the card's name and power limit, each fit's wall and stage walls,
and each route's median and quartiles.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--pairs", type=int, default=8)
    parser.add_argument("--seed", type=int, default=1234567)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("time_gar_eigh_routes: torch.cuda.is_available() is False; needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import smi_line
    from fidelityfusion_tpu_torch.ops import kron
    from portbench import harness
    from portbench.drivers import fit_gar

    cell = "gar.fit-poisson-2048"
    wl = harness.workload(cell)
    run = harness.Run(cell, args.seed, 0.0, False, wl, harness.config(wl["config"]),
                      harness.traffic(wl["traffic"]), device=torch.device("cuda", 0))
    torch.backends.cuda.matmul.allow_tf32 = False
    state = fit_gar.setup(run)  # builds the kernels and warms this cell's shapes
    routes = {"library": kron.eigh_plain, "K5": kron.small_eigh}
    for fn in routes.values():  # each route's first calls outside the timed fits
        kron.small_eigh = fn
        fit_gar.fit(run, state, -1, run.traffic["warm_steps"])
    walls = {route: [] for route in routes}
    print(smi_line(), flush=True)
    for i in range(args.pairs):
        order = ("library", "K5") if i % 2 == 0 else ("K5", "library")
        for route in order:
            kron.small_eigh = routes[route]
            out = fit_gar.fit(run, state, i, run.traffic["steps"])
            walls[route].append(out["wall"])
            print(f"pair {i} {route:7s} wall {out['wall']:.4f} s  stages "
                  f"{[round(s, 4) for s in out['stage_s']]}", flush=True)
    kron.small_eigh = routes["K5"]
    for route, w in walls.items():
        q = statistics.quantiles(w, n=4)
        print(f"{route}: median {statistics.median(w):.4f} s  quartiles {q[0]:.4f} {q[2]:.4f}  "
              f"over {len(w)} fits")
    wins = sum(k < lib for k, lib in zip(walls["K5"], walls["library"]))
    print(f"K5 faster in {wins} of {args.pairs} pairs; median ratio "
          f"{statistics.median(walls['K5']) / statistics.median(walls['library']):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
