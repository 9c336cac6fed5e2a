"""RMSEs of the JAX package's sweep harness on the cells `chip_smoke.py`'s
experiments phase runs with the port, on the CPU.

    python scripts/sweep_jax_bars.py

The grid protocol on forrester12, seed 0, at the harness's defaults (100
low-fidelity rows, 100 test points, 200 Adam steps a stage, 4 restarts,
lr 5e-2) for AR, ResGP, NAR, CAR, GAR and CIGAR at n_high 16 and 32,
CAR at `train_CAR`'s lr 1e-2 (at 5e-2 its restarts do not settle:
`scripts/car_lr_probe.py`); the
field protocol (`run_gar_field_sweep`, Poisson, non-aligned, resolutions
(8, 16), 100 steps) for GAR and CIGAR at n_high 32.  chip_smoke holds each
card cell's RMSE to 1.25 x the JAX RMSE printed here + 0.01 x std(y_test)
(it computes std(y_test) itself from the same numpy data).  Prints one
line per cell and, last, the dict chip_smoke carries.
"""

import os
import sys
import tempfile
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from fidelityfusion_tpu.experiments.sweep import run_gar_field_sweep, run_single  # noqa: E402

METHODS = ("AR", "ResGP", "NAR", "CAR", "GAR", "CIGAR")
LR = {"CAR": 1e-2}


def main():
    bars = {}
    for method in METHODS:
        for n_high in (16, 32):
            t = time.time()
            row = run_single(method, "forrester12", 0, n_high, lr=LR.get(method, 5e-2))
            bars[f"grid {method} {n_high}"] = row["rmse"]
            print(f"grid forrester12 {method} n_high {n_high}: rmse {row['rmse']!r} "
                  f"({time.time() - t:.1f} s)", flush=True)
    with tempfile.TemporaryDirectory() as out:
        for method in ("GAR", "CIGAR"):
            t = time.time()
            (row,) = run_gar_field_sweep(methods=(method,), seeds=(0,), n_high_grid=(32,),
                                         variant="non-aligned", resolutions=(8, 16),
                                         outdir=out)
            bars[f"field {method} 32"] = row["rmse"]
            print(f"field poisson non-aligned {method} n_high 32: rmse {row['rmse']!r} "
                  f"({time.time() - t:.1f} s)", flush=True)
    print(bars)


if __name__ == "__main__":
    main()
