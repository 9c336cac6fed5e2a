#!/usr/bin/env python3
"""How far a float32 HOGP NLML is from float64 at the JAX bench's shipping
shape, in the port (and, on the CPU, the JAX package).

    JAX_PLATFORMS=cpu python3 scripts/hogp_f32_vs_f64.py            # CPU, both packages
    python3 scripts/hogp_f32_vs_f64.py --device cuda [--steps 130]  # one GPU, the port

The problem is `bench.py:_hogp_setup(1024, (32, 32, 32))`: SE kernel,
every parameter 1 at the start.  With ``--steps`` the port first trains
it as `chip_smoke.py` does (tracked spectrum, refresh every 64, lr 1e-2).
At the initial (and the trained) parameters it prints the exact NLML
(`nll`) in float32 (the port builds and decomposes its Grams in float64),
from float32 Grams decomposed in float64, from float32 Grams with a
float32 ``eigh`` (as the JAX package does) and in float64, with their
distances to float64 relative to max(|NLML|, 1): neither a float32 Gram
nor a float32 ``eigh`` resolves K_0's small eigenvalues, which the
Kronecker product multiplies by the other modes' eigenvalue products.
"""

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def setup(device):
    n, shape = 1024, (32, 32, 32)
    rng = np.random.default_rng(0)
    x = rng.random((n, 4)).astype(np.float32)
    base = np.sin(2 * np.pi * x.sum(axis=1)).astype(np.float32)
    y = base.reshape((n, 1, 1, 1)) * rng.random(shape).astype(np.float32)
    return torch.tensor(x, device=device), torch.tensor(y, device=device), shape


def port_nlls(hogp, p, x, y):
    """float32 (the port: every Gram built and decomposed in float64),
    float32 Grams decomposed in float64, float32 Grams with a float32
    ``eigh`` (the JAX package's), float64 (on the CPU)."""
    from fidelityfusion_tpu_torch.ops import kron
    from fidelityfusion_tpu_torch.utils.tree import tree_map

    out = {}
    with torch.no_grad():
        out["port float32"] = float(hogp.nll(p, x, y))
        K0, K_modes = hogp._grams(p, x)
        Kb, yb, nb = kron._batched([K0] + K_modes, y, hogp.noise(p))
        Kb = [K.float() for K in Kb]
        pairs = [kron.eigh_pairs(K) for K in Kb]
        out["port float32, float32 Grams"] = float(kron._loss_and_saved(
            [q[0] for q in pairs], [q[1] for q in pairs], yb, nb)[0][0])
        pairs = [torch.linalg.eigh(0.5 * (K + K.transpose(-1, -2))) for K in Kb]
        out["port float32, float32 Grams, eigh in float32"] = float(kron._loss_and_saved(
            [q[0] for q in pairs], [q[1] for q in pairs], yb, nb)[0][0])
        # float64 on the CPU
        p64 = tree_map(lambda a: a.double().cpu(), p)
        out["port float64"] = float(hogp.nll(p64, x.double().cpu(), y.double().cpu()))
    return out


def jax_nlls(p, x, y, shape):
    import jax
    import jax.numpy as jnp

    from fidelityfusion_tpu.models.hogp import HOGP as JHOGP
    from fidelityfusion_tpu.ops.kernels import SquaredExponentialKernel as JSE

    jax.config.update("jax_platforms", "cpu")
    jh = JHOGP(kernel=JSE(), output_shape=shape)
    out = {}
    for dtype in ("float32", "float64"):
        with jax.enable_x64(dtype == "float64"):
            cast = lambda a: jnp.asarray(np.asarray(a.cpu(), np.float64), dtype)  # noqa: E731
            jp = {"kernel": {k: cast(v) for k, v in p["kernel"].items()},
                  "noise_variance": cast(p["noise_variance"])}
            out[f"jax {dtype}"] = float(jax.jit(jh.nll)(jp, cast(x), cast(y)))
    return out


def report(label, out):
    ref = out["port float64"]
    for key, v in out.items():
        print(f"{label}: {key}: NLML {v:.9f}  |NLML - port float64| / max(|NLML|, 1) "
              f"{abs(v - ref) / max(abs(ref), 1.0):.3e}", flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--steps", type=int, default=0)
    args = parser.parse_args(argv)

    from fidelityfusion_tpu_torch.models.hogp import HOGP
    from fidelityfusion_tpu_torch.ops.kernels import SquaredExponentialKernel
    from fidelityfusion_tpu_torch.train.fit import fit
    from fidelityfusion_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    x, y, shape = setup(device)
    hogp = HOGP(kernel=SquaredExponentialKernel(), output_shape=shape)
    p = hogp.init_params(4, device=device)
    out = port_nlls(hogp, p, x, y)
    if device.type == "cpu":
        out.update(jax_nlls(p, x, y, shape))
    report("initial parameters", out)
    if args.steps:
        res = fit(lambda q, aux, step, x, y: hogp.nll_tracked(q, aux, step, x, y,
                                                              refresh_every=64),
                  p, steps=args.steps, lr=1e-2, loss_args=(x, y),
                  aux0=hogp.tracking_aux0(len(x), device=device))
        out = port_nlls(hogp, res.params, x, y)
        out["port float32, tracked (the last step's loss)"] = float(res.losses[-1])
        report(f"after {args.steps} tracked steps", out)


if __name__ == "__main__":
    main()
