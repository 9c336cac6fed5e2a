"""Final incumbents of the JAX package's discrete MFBO loop on the runs
`chip_smoke.py`'s BO phase makes with the port, on the CPU.

    python scripts/mfbo_jax_bars.py

`mf_bo_discrete(Forrester(2), model_name="AR", bo_iterations=10,
init_index={1: 10, 2: 4})` at the loop's defaults: UCB on seeds 0, 1 and 2,
EI, ES and cfKG on seed 0.  chip_smoke holds each port run's final
incumbent to 15.0 (UCB: the median of the seeds); where the JAX loop
itself ends under 15.0 from the same seed and design, the bar is the JAX
final less 0.3, which this script prints.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from fidelityfusion_tpu.bo.loop import mf_bo_discrete  # noqa: E402
from fidelityfusion_tpu.data.objectives import Forrester  # noqa: E402

RUNS = (("UCB", 0), ("UCB", 1), ("UCB", 2), ("EI", 0), ("ES", 0), ("cfKG", 0))


def main():
    finals = {}
    for method, seed in RUNS:
        rec = mf_bo_discrete(Forrester(2), method=method, model_name="AR", bo_iterations=10,
                             init_index={1: 10, 2: 4}, seed=seed)
        finals[method, seed] = rec["incumbents"][-1]
        print(f"JAX {method} seed {seed}: S {rec['S']}, final incumbent {finals[method, seed]!r}, "
              f"cost {rec['cost'][-1]!r}", flush=True)
    ucb = sorted(finals["UCB", s] for s in (0, 1, 2))[1]
    for method, final in (("UCB", ucb), ("EI", finals["EI", 0]), ("ES", finals["ES", 0]),
                          ("cfKG", finals["cfKG", 0])):
        bar = 15.0 if final >= 15.0 else final - 0.3
        print(f"{method}: JAX final {final!r} -> bar {bar!r}")


if __name__ == "__main__":
    main()
