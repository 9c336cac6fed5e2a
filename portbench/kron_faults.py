"""Faults planted under the GAR cell's timed path, to show that its
comparison fails: context managers in the pattern of `portbench/faults.py`,
which patch the program's functions in this process and restore them.

    frozen_steps    every Adam step of the trainer returns its state unchanged
                    (`faults.frozen_steps`)
    half_rows       every stage's NLML (`HOGP.nll`, `HOGP.nll_tracked`) over
                    the first half of its rows (`faults.half_rows`)
    altered_fields  the cascade's answer (mean and variance) shifted by 1
                    where `GAR.forward` produces it
    kron_float32    the Kronecker path's Grams and eigenpairs in float32, the
                    precision the configuration rules out: `HOGP._grams`
                    builds K_0 and the mode Grams in float32 and
                    `kron.eigh_pairs` (the refreshes and the exact ``eigh``)
                    decomposes in the Gram's own dtype, so the tracked
                    Jacobi sweeps and the backward's rotations run in
                    float32 too

and one probe, which is no fault:

    exact_spectrum  every step of the tracked NLML refreshes mode 0's
                    eigenpairs with a full ``eigh`` (`spectral.tracked_eigh`
                    as at a refresh step), so the trajectory readings show
                    what the tracking itself leaves

    python3 -m portbench.kron_faults --workload <cell> --fault <name> --seeds 1 2 3

prints one JSON line per seed with the cell's readings under the fault
(or probe) beside its limits, as `control.py --fault` does for
`faults.py`'s.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from portbench import faults


def altered_fields():
    from fidelityfusion_tpu_torch.models.gar import GAR

    forward = GAR.forward

    def shifted(self, *args, **kwargs):
        mean, var = forward(self, *args, **kwargs)
        return mean + 1.0, var + 1.0

    return faults._patched((GAR, "forward", shifted), (GAR, "__call__", shifted))


def half_rows():
    import torch

    from fidelityfusion_tpu_torch.models.hogp import HOGP

    nll, nll_tracked = HOGP.nll, HOGP.nll_tracked

    def halves(self, x, y, y_var):
        h = x.shape[0] // 2
        rows = y.ndim - len(self.output_shape) - 1  # y's row axis: 0, or 1 under a restart axis
        return (h, x[:h], y.narrow(rows, 0, h), None if y_var is None else y_var[..., :h])

    def half(self, params, x_train, y_train, y_var=None):
        _, x, y, yv = halves(self, x_train, y_train, y_var)
        return nll(self, params, x, y, yv)

    def half_tracked(self, params, aux, step, x_train, y_train, y_var=None, **kwargs):
        h, x, y, yv = halves(self, x_train, y_train, y_var)
        n = x_train.shape[0]
        loss, (V, *rest) = nll_tracked(self, params, (aux[0][..., :h, :h], *aux[1:]), step, x,
                                       y, yv, **kwargs)
        # the carried basis keeps the trainer's (n, n) shape, the half's in its corner
        return loss, (torch.nn.functional.pad(V, (0, n - h, 0, n - h)), *rest)

    return faults._patched((HOGP, "nll", half), (HOGP, "nll_tracked", half_tracked))


def exact_spectrum():
    from fidelityfusion_tpu_torch.ops import spectral

    def refresh(K, V_prev, step, refresh_every=64, sweeps=1):
        return spectral._refresh(K)

    return faults._patched((spectral, "tracked_eigh", refresh))


def kron_float32():
    import torch

    from fidelityfusion_tpu_torch.models.hogp import HOGP
    from fidelityfusion_tpu_torch.ops import kron, spectral
    from fidelityfusion_tpu_torch.utils.tree import tree_map

    def grams(self, params, x_train, y_var=None):
        f32 = torch.float32
        kp = tree_map(lambda a: a.to(f32), params["kernel"])
        jit = torch.tensor(self.jitter, dtype=f32, device=x_train.device)
        K0 = self.kernel.apply(kp, x_train.to(f32), x_train.to(f32), diag_add=jit,
                               y_var=None if y_var is None else y_var.to(f32))
        return K0, [self._mode_gram(kp, g.to(f32)) for g in self.grids(params)]

    def eigh_pairs(K):
        bad = ~torch.isfinite(K).all(-1).all(-1)
        eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
        K = torch.where(bad[..., None, None], eye, 0.5 * (K + K.transpose(-1, -2)))
        w, V = torch.linalg.eigh(K)
        return torch.where(bad[..., None], torch.full_like(w, float("nan")), w), V

    return faults._patched((HOGP, "_grams", grams), (kron, "eigh_pairs", eigh_pairs),
                           (spectral, "eigh_pairs", eigh_pairs))


FAULTS = {"frozen_steps": faults.frozen_steps, "half_rows": half_rows,
          "altered_fields": altered_fields, "kron_float32": kron_float32}
PROBES = {"exact_spectrum": exact_spectrum}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", required=True, choices=sorted({**FAULTS, **PROBES}))
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0, help="the runs' window")
    args = ap.parse_args(argv)
    from portbench import harness

    harness.set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("portbench.kron_faults needs a CUDA device", file=sys.stderr)
        return 3
    for seed in args.seeds:
        t0 = time.time()
        with {**FAULTS, **PROBES}[args.fault]():
            out = harness.execute(args.workload, seed, args.seconds, False, t0,
                                  torch.device("cuda", 0))
        print(json.dumps({"seed": seed, "fault": args.fault, "correct": out["correct"],
                          "readings": {**out["checks"],
                                       **{k: {"value": v} for k, v in out["info"].items()}},
                          "seconds": time.time() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
