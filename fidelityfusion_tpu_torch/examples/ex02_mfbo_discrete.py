"""Example 2: discrete multi-fidelity Bayesian optimization on Forrester.

Port of `examples/02_mfbo_discrete.py`
(`Experiments/MFBO_discrete/MF_BO_discrete.py:33-152`):

    python -m fidelityfusion_tpu_torch.examples.ex02_mfbo_discrete [--device cpu]
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--iterations", type=int, default=6)
    args = parser.parse_args(argv)

    from fidelityfusion_tpu_torch.bo.loop import mf_bo_discrete
    from fidelityfusion_tpu_torch.data.objectives import Forrester

    record = mf_bo_discrete(Forrester(2), method="UCB", model_name="AR",
                            bo_iterations=args.iterations, init_index={1: 10, 2: 4}, seed=0,
                            verbose=True, device=args.device)
    print("incumbents:", [round(v, 3) for v in record["incumbents"]])
    print("cost:", record["cost"])
    return record


if __name__ == "__main__":
    main()
