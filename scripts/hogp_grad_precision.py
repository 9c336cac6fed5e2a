#!/usr/bin/env python3
"""Where a float32 HOGP gradient loses its digits, in the port.

    python3 scripts/hogp_grad_precision.py                  # one GPU, hogp1024
    python3 scripts/hogp_grad_precision.py --device cpu --n 64 --shape 8 8 8

The problem is `chip_smoke.py`'s hogp1024 (n = 1024, output (32, 32, 32),
SE kernel, the initial parameters).  The port builds the Kronecker Grams
and their eigenpairs in float64 and runs the NLML's tail and its
closed-form backward (`ops/kron.py:_kron_nlml_bwd`) in the targets'
float32.  The script takes every parameter's gradient seven ways:

- ``float64``: the whole NLML and backward in float64 (the reference);
- ``port``: `HOGP.nll` as the port runs it (the tail in float32, each
  mode Gram's cotangent rotated back to the Gram's basis in float64);
- ``f32 eigenpairs``: the eigenpairs rounded to float32, all arithmetic
  after them in float64 (is the rounding of the inputs the loss?);
- ``f32 tail, f64 rotation``: the backward as the port runs it up to each
  mode's eigen-space cotangent ``D_m = s (diag(w_m) - G_m G_m^T)``, its
  rotation ``V_m D_m V_m^T`` back to the Gram's basis in float64 (as
  the port);
- ``f32 tail, f64 eigen-space products``: ``w_m`` and ``G_m G_m^T`` summed
  in float64 from the port's float32 ``U``, ``beta`` and eigenvalues, the
  rotation in float32;
- ``f32 tail, f64 products``: both of the last two in float64;
- ``f32 tail and rotation``: every step after the eigenpairs in float32.

Each gradient is printed beside float64's, with its error per leaf
relative to the leaf.  Prints the card's name and power limit first (on a
GPU); the last line is a JSON object of every reading.  Imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def setup(n, shape, device):
    """`chip_smoke.py:_hogp1024_data` at (n, shape), seed 0."""
    rng = np.random.default_rng(0)
    x = rng.random((n, 4)).astype(np.float32)
    base = np.sin(2 * np.pi * x.sum(axis=1)).astype(np.float32)
    y = base.reshape((n,) + (1,) * len(shape)) * rng.random(shape).astype(np.float32)
    return torch.as_tensor(x, device=device), torch.as_tensor(y, device=device)


def backward_parts(eigvals, eigvecs, A, T1, prod_dtype, rot_dtype):
    """`ops/kron.py:_kron_nlml_bwd`'s mode-Gram cotangents (t = 1, no
    batch), with ``w_m`` and ``G_m G_m^T`` summed in ``prod_dtype`` and
    the rotation ``V D V^T`` in ``rot_dtype``."""
    from fidelityfusion_tpu_torch.ops.kron import multi_mode_dot, rank1_tucker

    M1 = len(eigvals)
    nd = float(math.prod(T1.shape))
    U = 1.0 / A
    beta = T1 * U
    sqrt_lams = [torch.sqrt(torch.clamp(lam, min=0.0)) for lam in eigvals]
    dKs = []
    for m in range(M1):
        others = [j for j in range(M1) if j != m]
        w = multi_mode_dot(U.to(prod_dtype), [eigvals[j].to(prod_dtype)[None, :] for j in others],
                           modes=others).reshape(-1)
        gamma = beta * rank1_tucker([sqrt_lams[j] if j != m else torch.ones_like(sqrt_lams[j])
                                     for j in range(M1)])
        G = torch.movedim(gamma, m, 0).reshape(gamma.shape[m], -1).to(prod_dtype)
        D = (0.5 / nd) * (torch.diag(w) - G @ G.T)
        V = eigvecs[m].to(rot_dtype)
        dKs.append(V @ D.to(rot_dtype) @ V.T)
    return dKs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--n", type=int, default=1024)
    parser.add_argument("--shape", type=int, nargs="+", default=[32, 32, 32])
    args = parser.parse_args(argv)

    from fidelityfusion_tpu_torch.models.hogp import HOGP
    from fidelityfusion_tpu_torch.ops import kron
    from fidelityfusion_tpu_torch.ops.kernels import SquaredExponentialKernel
    from fidelityfusion_tpu_torch.utils.tree import tree_leaves, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    device = torch.device(args.device)
    if device.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    shape = tuple(args.shape)
    x, y = setup(args.n, shape, device)
    hogp = HOGP(kernel=SquaredExponentialKernel(), output_shape=shape)
    p32 = hogp.init_params(4, device=device)
    f64 = torch.float64
    names = ["length_scale", "signal_variance", "noise_variance"]

    def grads(loss_fn, p):
        p = tree_map(lambda a: a.detach().clone().requires_grad_(True), p)
        return [g.reshape(-1) for g in torch.autograd.grad(loss_fn(p), tree_leaves(p))]

    def through_grams(p, dKs, dnoise):
        """Parameter gradients from the mode-Gram cotangents ``dKs``
        (float64 Grams) and the noise's."""
        p = tree_map(lambda a: a.detach().to(f64).requires_grad_(True), p)
        K0, K_modes = hogp._grams(p, x)
        noise = hogp.noise(p)
        outs = list(torch.autograd.grad([K0] + K_modes + [noise], tree_leaves(p),
                                        grad_outputs=[d.to(f64) for d in dKs]
                                        + [dnoise.to(f64).reshape(noise.shape)]))
        return [g.reshape(-1) for g in outs]

    readings = {}
    readings["float64"] = grads(
        lambda q: hogp.nll(q, x.to(f64), y.to(f64)), tree_map(lambda a: a.to(f64), p32))
    readings["port"] = grads(lambda q: hogp.nll(q, x, y), p32)

    with torch.no_grad():
        K0, K_modes = hogp._grams(p32, x)
        pairs = [kron.eigh_pairs(K) for K in [K0] + K_modes]  # float64
        noise64 = hogp.noise(p32).to(f64)

        def tail(dtype, prod_dtype, rot_dtype):
            vals = [w.to(torch.float32).to(dtype) for w, _ in pairs]
            vecs = [V.to(torch.float32).to(dtype) for _, V in pairs]
            _, vals, A, T1 = kron._loss_and_saved(vals, vecs, y.to(dtype)[None],
                                                  noise64.to(dtype).reshape(1))
            A, T1 = A[0], T1[0]
            dKs = backward_parts(vals, vecs, A, T1, prod_dtype, rot_dtype)
            nd = float(T1.numel())
            dnoise = (0.5 / nd) * ((1.0 / A).sum() - ((T1 / A) ** 2).sum())
            return dKs, dnoise

        variants = {"f32 eigenpairs": (f64, f64, f64),
                    "f32 tail, f64 rotation": (torch.float32, torch.float32, f64),
                    "f32 tail, f64 eigen-space products": (torch.float32, f64, torch.float32),
                    "f32 tail, f64 products": (torch.float32, f64, f64),
                    "f32 tail and rotation": (torch.float32,) * 3}
        parts = {k: tail(*v) for k, v in variants.items()}
    for k, (dKs, dnoise) in parts.items():
        readings[k] = through_grams(p32, dKs, dnoise)

    ref = readings["float64"]
    out = {"n": args.n, "shape": list(shape), "device": str(device), "gradients": {},
           "rel_err": {}}
    for k, g in readings.items():
        errs = {nm: float((a.double() - b).abs().max() / b.abs().max().clamp_min(1e-300))
                for nm, a, b in zip(names, g, ref)}
        out["gradients"][k] = {nm: float(a.double().sum()) for nm, a in zip(names, g)}
        out["rel_err"][k] = errs
        print(f"{k:>38}: " + "  ".join(f"{nm} {float(a.double().sum()): .6e} ({errs[nm]:.2e})"
                                      for nm, a in zip(names, g)), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
