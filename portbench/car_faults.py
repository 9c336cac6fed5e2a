"""Faults planted under the CAR-large cell's timed path, to show that its
comparison fails: context managers in the pattern of `portbench/faults.py`,
which patch the program's functions in this process and restore them.

    frozen_steps  every Adam step of the trainer returns its state unchanged
                  (`faults.frozen_steps`)
    half_rows     the joint NLML (`GPBasic.nll`) over every second stacked
                  row, so the fit sees half of them; `forward` sees all
    one_fidelity  the feature map (`ContinuousFidelityKernel.features`)
                  takes s = 1 for every row, which drops the fidelity factor
    mc_half       the feature map averages over the first half of its
                  Monte-Carlo draws of t, in the program only (the
                  reference keeps all of them)
    mc_reseeded   the kernel draws its w and t from the seed after its
                  own, in the program only (the reference draws from the
                  configuration's ``mc_seed``)

    python3 -m portbench.car_faults --workload <cell> --fault <name> --seeds 1 2 3

prints one JSON line per seed with the cell's readings under the fault
beside its limits, as `kron_faults.py` does.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from portbench import faults


def half_rows():
    from fidelityfusion_tpu_torch.models.cigp import GPBasic

    nll = GPBasic.nll

    def half(self, params, x, y, y_var=None, mask=None):
        return nll(self, params, x[::2].contiguous(), y[::2].contiguous(), y_var, mask)

    return faults._patched((GPBasic, "nll", half))


def one_fidelity():
    import torch

    from fidelityfusion_tpu_torch.models.car import ContinuousFidelityKernel

    features = ContinuousFidelityKernel.features

    def constant(self, params, s):
        return features(self, params, torch.ones_like(s))

    return faults._patched((ContinuousFidelityKernel, "features", constant))


def mc_half():
    from fidelityfusion_tpu_torch.models.car import ContinuousFidelityKernel

    features = ContinuousFidelityKernel.features

    def half(self, params, s):
        t = params["_t"]
        return features(self, {**params, "_t": t[: t.shape[0] // 2]}, s)

    return faults._patched((ContinuousFidelityKernel, "features", half))


def mc_reseeded():
    import dataclasses

    from fidelityfusion_tpu_torch.models.car import ContinuousFidelityKernel

    init_params = ContinuousFidelityKernel.init_params

    def reseeded(self, input_dim, device="cuda"):
        return init_params(dataclasses.replace(self, seed=self.seed + 1), input_dim, device)

    return faults._patched((ContinuousFidelityKernel, "init_params", reseeded))


FAULTS = {"frozen_steps": faults.frozen_steps, "half_rows": half_rows,
          "one_fidelity": one_fidelity, "mc_half": mc_half, "mc_reseeded": mc_reseeded}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", required=True, choices=sorted(FAULTS))
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0, help="the runs' window")
    args = ap.parse_args(argv)
    from portbench import harness

    harness.set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("portbench.car_faults needs a CUDA device", file=sys.stderr)
        return 3
    for seed in args.seeds:
        t0 = time.time()
        with FAULTS[args.fault]():
            out = harness.execute(args.workload, seed, args.seconds, False, t0,
                                  torch.device("cuda", 0))
        print(json.dumps({"seed": seed, "fault": args.fault, "correct": out["correct"],
                          "readings": out["checks"], "seconds": time.time() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
