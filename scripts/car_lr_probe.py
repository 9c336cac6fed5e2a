"""Staged CAR's grid cell (forrester12, n_high 32, seed 0, the sweep
harness's defaults: 100 low rows, 200 steps a stage, 4 restarts) at one
learning rate, on each device named, for the data as drawn and three
copies with the low-fidelity targets perturbed by 1e-7 relative.

    python scripts/car_lr_probe.py --lr 5e-2 [--devices cuda cpu]

Prints per run the test RMSE and each stage's final NLML per restart;
for a run on the card also the RMSE of the card-trained parameters
through the CPU's forward (whether a difference lies in training or in
prediction).  At lr 5e-2 the restarts do not settle, so the chosen
restart and the RMSE move with rounding; at `train_CAR`'s lr 1e-2 they
agree to a few units of NLML.
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fidelityfusion_tpu_torch.convert import load_state  # noqa: E402
from fidelityfusion_tpu_torch.experiments import load_mfdata, sweep  # noqa: E402
from fidelityfusion_tpu_torch.train.fit import restart_scores  # noqa: E402
from fidelityfusion_tpu_torch.utils.tree import tree_map  # noqa: E402


def _rmse(mean, y):
    return float(np.sqrt(np.mean((mean.detach().cpu().numpy() - y) ** 2)))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--lr", type=float, default=5e-2)
    parser.add_argument("--devices", nargs="+", default=["cuda", "cpu"])
    args = parser.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    for k in range(4):
        d = load_mfdata.load_data("forrester12", n_train_high=32, seed=0)
        if k:
            r = np.random.default_rng(k)
            d["y_low"] = d["y_low"] * (1 + 1e-7 * r.standard_normal(d["y_low"].shape))
        for dev in args.devices:
            dm = sweep._two_fidelity_manager(d["x_low"], d["y_low"], d["x_high"], d["y_high"])
            model, train = sweep._build_model("CAR", d["y_low"], d["y_high"], True, 1, dev)
            hists = train(model, dm, max_iter=200, lr_init=args.lr, n_restarts=4)
            scores = [np.round(restart_scores(h.cpu()), 3).tolist() for h in hists]
            mean, _ = model.forward(dm, d["x_test"])
            extra = ""
            if dev != "cpu":
                cpu_model, _ = sweep._build_model("CAR", d["y_low"], d["y_high"], True, 1, "cpu")
                load_state(cpu_model, tree_map(lambda a: a.detach().cpu().numpy(), model.params),
                           model.stage_norm)
                extra = (f"; card params, CPU forward rmse "
                         f"{_rmse(cpu_model.forward(dm, d['x_test'])[0], d['y_test']):.5f}")
            print(f"lr {args.lr} perturbation {k} {dev}: rmse {_rmse(mean, d['y_test']):.5f} "
                  f"stage NLML by restart {scores}{extra}", flush=True)


if __name__ == "__main__":
    main()
