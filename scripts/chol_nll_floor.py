#!/usr/bin/env python3
"""How far two float32 factorizations' NLMLs lie apart, on one GPU.

    python3 scripts/chol_nll_floor.py [--seeds 10]

Measures where float32 rounding puts the NLML checks of `chip_smoke.py`'s
K2/K3a cases (`kernel_checks`'s `chol_case`, `panel_checks`):

- at each of chol_case's shapes, over ``--seeds`` data seeds drawn as
  chol_case draws them, the kernels' NLML against the plain float32
  version's (the largest relative difference in the batch) and the ratio
  of their errors against the plain float64 NLML (summed over the batch);
- `panel_checks`' float64 ratios at one 64-row panel over 64 Grams on the
  same number of further data seeds.

Prints the card's name and power limit first; the last line is a JSON
object of every reading.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SHAPES = ((1, 64), (4, 64), (4, 256), (4, 512), (4, 1024), (1, 1024))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=10, help="data seeds per shape")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chol_nll_floor: needs a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    from fidelityfusion_tpu_torch.ops import chol, cuda, gram as G
    from fidelityfusion_tpu_torch.ops.chol import chol_inv, chol_inv_plain, tri_inv, tri_inv_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    device = torch.device("cuda")
    cuda.build([G._LIB, chol._CHOL, chol._TRI])
    print(cs.smi_line(), flush=True)

    out = {"shapes": {}, "panel": []}
    for R, n in SHAPES:
        rel, ratio = [], []
        for seed in range(100, 100 + args.seeds):
            gen = torch.Generator().manual_seed(seed)
            x, inv_ls, sv, da = cs.se_problem(torch, R, n, 1, gen, device)
            A = G.gram_plain(x, x, inv_ls, sv, da)
            A = A if R > 1 else A[0]  # one matrix through K2, a batch through K3a
            y = torch.sin(2.0 * x) + 0.05 * torch.randn((n, 1), generator=gen).to(device)
            L, Wd = chol_inv(A)
            Lp, Wdp = chol_inv_plain(A.reshape(-1, n, n))
            L64, Wd64 = chol_inv_plain(A.reshape(-1, n, n).double())
            v_k = cs.nll_of(torch, L, tri_inv(L, Wd), y).reshape(-1)
            v_p = cs.nll_of(torch, Lp, tri_inv_plain(Lp, Wdp), y)
            v64 = cs.nll_of(torch, L64, tri_inv_plain(L64, Wd64), y.double())
            rel.append(((v_k - v_p).abs() / v_p.abs()).max().item())
            ratio.append((v_k.double() - v64).abs().sum().item()
                         / (v_p.double() - v64).abs().sum().item())
        out["shapes"][f"R={R} n={n}"] = dict(rel_vs_plain=rel, f64_error_ratio=ratio)
        print(f"R={R} n={n}: kernels vs plain fp32, max rel in the batch: max "
              f"{max(rel):.3e} over {args.seeds} seeds {[f'{r:.1e}' for r in rel]}; "
              f"error vs fp64, kernels / plain fp32: {min(ratio):.3f}-{max(ratio):.3f}",
              flush=True)
    for seed in range(200, 200 + args.seeds):
        report = {}
        cs.panel_checks(torch, device, report, seed=seed)
        out["panel"].append({live: {k: v[1] / report["panel64"][live]["plain fp32"][1]
                                    for k, v in r.items() if k in ("K2", "K3a")}
                             for live, r in report["panel64"].items()})
    ratios = [v for p in out["panel"] for r in p.values() for v in r.values()]
    print(f"panel_checks over {args.seeds} seeds: NLML error ratio {min(ratios):.3f}-"
          f"{max(ratios):.3f}; failed checks {len(cs.FAILURES)}", flush=True)
    print(json.dumps(out))
    return 1 if cs.FAILURES else 0


if __name__ == "__main__":
    sys.exit(main())
