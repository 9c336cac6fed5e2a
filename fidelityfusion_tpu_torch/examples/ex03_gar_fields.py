"""Example 3: GAR on non-aligned multi-fidelity PDE fields.

Port of `examples/03_gar_fields.py` (the reference's GAR/Poisson demo,
`GAR.py:129-190`, with the field data regenerated by the built-in
solver):

    python -m fidelityfusion_tpu_torch.examples.ex03_gar_fields [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from fidelityfusion_tpu_torch.data.pde import generate_poisson_mf_dataset
    from fidelityfusion_tpu_torch.models.data_manager import MultiFidelityDataManager
    from fidelityfusion_tpu_torch.models.gar import GAR, train_GAR
    from fidelityfusion_tpu_torch.ops.kernels import ARDKernel
    from fidelityfusion_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    x, ys = generate_poisson_mf_dataset(n_samples=64, resolutions=(8, 12, 16), d_in=4)
    n_tr = 48
    dm = MultiFidelityDataManager([
        {"raw_fidelity_name": str(i), "fidelity_indicator": i, "X": x[:n_tr], "Y": y[:n_tr]}
        for i, y in enumerate(ys)])
    model = GAR(3, [ARDKernel()] * 3, [y.shape[1:] for y in ys], input_dim=4, device=device)
    train_GAR(model, dm, max_iter=100, lr_init=5e-2)
    mean, _ = model(dm, x[n_tr:])
    truth = ys[-1][n_tr:]
    rel = float(np.linalg.norm(mean.detach().cpu().numpy() - truth) / np.linalg.norm(truth))
    print(f"GAR relative L2 error on held-out fields: {rel:.3f}")
    return rel


if __name__ == "__main__":
    main()
