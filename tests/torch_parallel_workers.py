"""The rank program of `tests/test_torch_parallel.py`: the port's side of
its comparisons, run by every rank of a gloo world on the CPU.

    python tests/torch_parallel_workers.py INPUTS OUT TASK [TASK ...] \\
        --rank R --world-size W --port P

It imports torch, numpy and the port only (a rank must not import JAX).
``INPUTS`` is a `torch.save` file of numpy inputs keyed by task, written
by the test module; rank 0 writes the tasks' results, numpy again, to
``OUT``.  Every rank calls every task (the sharded functions are SPMD
programs), with one thread each, so four ranks share the box's cores.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from fidelityfusion_tpu_torch.utils.tree import tree_leaves, tree_map  # noqa: E402


def _t(tree, dtype=torch.float32, grad=False):
    return tree_map(lambda a: torch.tensor(np.asarray(a), dtype=dtype).requires_grad_(grad), tree)


def _np(tree):
    return tree_map(lambda a: a.detach().cpu().numpy(), tree)


def _value_grad(fn, params):
    v = fn(params)
    g = torch.autograd.grad(v.sum(), tree_leaves(params))
    it = iter(g)
    return v.detach().numpy(), _np(tree_map(lambda _: next(it), params))


def _gp(kind):
    from fidelityfusion_tpu_torch.models.cigp import CIGP
    from fidelityfusion_tpu_torch.ops.kernels import ARDKernel, SquaredExponentialKernel

    kernel = ARDKernel() if kind == "ard" else SquaredExponentialKernel()
    return CIGP(kernel=kernel, se_analytic_nll=False)


def task_nll(inp, meshes):
    from fidelityfusion_tpu_torch.parallel import cigp_nll_nsharded

    out = []
    for c in inp:
        gp = _gp(c["kernel"])
        x, y = torch.tensor(c["x"]), torch.tensor(c["y"])
        yv = None if c["y_var"] is None else torch.tensor(c["y_var"])
        out.append(_value_grad(lambda p: cigp_nll_nsharded(gp, p, x, y, meshes["n"], y_var=yv),
                               _t(c["params"], grad=True)))
    return out


def task_nll64(inp, meshes):
    """Float64: the sharded NLML and its gradient beside the port's own
    unsharded `CIGP.nll`."""
    from fidelityfusion_tpu_torch.parallel import cigp_nll_nsharded

    out = []
    for c in inp:
        gp = _gp(c["kernel"])
        f64 = torch.float64
        x, y = torch.tensor(c["x"], dtype=f64), torch.tensor(c["y"], dtype=f64)
        p = _t(c["params"], f64, grad=True)
        out.append((_value_grad(lambda q: cigp_nll_nsharded(gp, q, x, y, meshes["n"]), p),
                    _value_grad(lambda q: gp.nll(q, x, y), p)))
    return out


def task_posterior(inp, meshes):
    from fidelityfusion_tpu_torch.parallel import cigp_posterior_nsharded

    return [_np(cigp_posterior_nsharded(_gp("ard"), _t(c["params"]), torch.tensor(c["x"]),
                                        torch.tensor(c["y"]), torch.tensor(c["xt"]),
                                        meshes["n"]))
            for c in inp]


def task_restarts(inp, meshes):
    """`restarts_nll_nsharded` on the (2, 2) mesh, restarts on "r": the
    AR rho stage (``residual``) and the CIGAR lift (``lift``)."""
    from fidelityfusion_tpu_torch.models.coupling import TensorLinear
    from fidelityfusion_tpu_torch.parallel import restarts_nll_nsharded

    x, yl, yh = (torch.tensor(inp[k]) for k in ("x", "yl", "yh"))
    out = {}
    for kind in ("residual", "lift"):
        lift = (TensorLinear(tuple(inp["l_shape"]), tuple(inp["h_shape"])) if kind == "lift"
                else None)
        ylk, yhk = (yl, yh) if kind == "residual" else (torch.tensor(inp["yl_t"]),
                                                       torch.tensor(inp["yh_t"]))
        out[kind] = _value_grad(
            lambda pb, a=ylk, b=yhk, lift=lift: restarts_nll_nsharded(
                _gp("ard"), pb, x, None, meshes["rn"], r_axis="r",
                residual=(a, b, inp["shift"], inp["scale"]), lift=lift),
            _t(inp[f"batch_{kind}"], grad=True))
    return out


def task_fit_nsharded(inp, meshes):
    from fidelityfusion_tpu_torch.parallel import fit_nsharded

    good, losses = fit_nsharded(_gp("ard"), _t(inp["params"]), torch.tensor(inp["x"]),
                                torch.tensor(inp["y"]), meshes["n"], steps=inp["steps"], lr=5e-2)
    return _np(good), losses.numpy()


def task_fit_restarts(inp, meshes):
    from fidelityfusion_tpu_torch.parallel import fit_restarts_nsharded

    best, final = fit_restarts_nsharded(_gp("ard"), _t(inp["batch"]), torch.tensor(inp["x"]),
                                        torch.tensor(inp["y"]), meshes["rn"], steps=inp["steps"],
                                        lr=5e-2, r_axis="r")
    return _np(best), final.numpy()


def _hogp(shape):
    from fidelityfusion_tpu_torch.models.hogp import HOGP
    from fidelityfusion_tpu_torch.ops.kernels import ARDKernel

    return HOGP(kernel=ARDKernel(), output_shape=tuple(shape))


def task_hogp(inp, meshes):
    from fidelityfusion_tpu_torch.parallel import hogp_nll_tracked_nsharded

    out = []
    for c in inp:
        hogp = _hogp(c["shape"])
        x, y = torch.tensor(c["x"]), torch.tensor(c["y"])
        yv = None if c["y_var"] is None else torch.tensor(c["y_var"])
        aux = (torch.tensor(c["V_prev"]), torch.zeros(()))
        out.append(_value_grad(
            lambda p: hogp_nll_tracked_nsharded(hogp, p, aux, c["step"], x, y, meshes["n"],
                                                refresh_every=64, y_var=yv)[0],
            _t(c["params"], grad=True)))
    return out


def task_hogp64(inp, meshes):
    """Float64: the sharded tracked Kronecker NLML and its gradient beside
    the port's own unsharded `HOGP.nll_tracked`."""
    from fidelityfusion_tpu_torch.parallel import hogp_nll_tracked_nsharded

    out = []
    f64 = torch.float64
    for c in inp:
        hogp = _hogp(c["shape"])
        x, y = torch.tensor(c["x"], dtype=f64), torch.tensor(c["y"], dtype=f64)
        aux = (torch.tensor(c["V_prev"], dtype=f64), torch.zeros((), dtype=f64))
        p = _t(c["params"], f64, grad=True)
        out.append((_value_grad(lambda q: hogp_nll_tracked_nsharded(
            hogp, q, aux, c["step"], x, y, meshes["n"], refresh_every=64)[0], p),
                    _value_grad(lambda q: hogp.nll_tracked(q, aux, c["step"], x, y,
                                                           refresh_every=64)[0], p)))
    return out


def task_fit_hogp(inp, meshes):
    from fidelityfusion_tpu_torch.parallel import fit_hogp_nsharded

    good, losses, _ = fit_hogp_nsharded(_hogp(inp["shape"]), _t(inp["params"]),
                                        torch.tensor(inp["x"]), torch.tensor(inp["y"]),
                                        meshes["n"], steps=inp["steps"], lr=5e-2)
    return _np(good), losses.numpy()


def task_mesh(inp, meshes):
    """The three mesh helpers over a 1-D "restart" mesh of every rank."""
    from fidelityfusion_tpu_torch.models.cigp import CIGP
    from fidelityfusion_tpu_torch.ops.kernels import SquaredExponentialKernel
    from fidelityfusion_tpu_torch.parallel import (
        sharded_acq_argmax, sharded_fit_restarts, sharded_posterior_mean)

    gp = CIGP(kernel=SquaredExponentialKernel())
    x, y = torch.tensor(inp["x"]), torch.tensor(inp["y"])
    mesh = meshes["restart"]
    best, res = sharded_fit_restarts(lambda p: gp.nll(p, x, y), _t(inp["batch"]), mesh,
                                     steps=30, lr=5e-2)
    params = _t(inp["params"])

    def acq(xs):
        mean, var = gp.predict_diag(params, x, y, xs)
        return mean.reshape(-1) + torch.sqrt(torch.clamp(var, min=0.0))

    cands = torch.tensor(inp["cands"])
    bx, bv = sharded_acq_argmax(acq, cands, mesh)
    with torch.no_grad():
        vals = acq(cands)
    mean = sharded_posterior_mean(gp.kernel.apply, params["kernel"], x, torch.tensor(inp["alpha"]),
                                  torch.tensor(inp["xt"]), mesh)
    return {"best": _np(best), "losses": res.losses.numpy(), "bx": bx.numpy(), "bv": float(bv),
            "vals": vals.numpy(), "mean": mean.numpy()}


def task_sweep(inp, meshes):
    from fidelityfusion_tpu_torch.experiments.sharded_sweep import run_sharded_seed_sweep

    return run_sharded_seed_sweep(mesh=meshes["restart"], device="cpu", **inp)


task_sweep200 = task_sweep


def task_scaling(inp, meshes):
    from fidelityfusion_tpu_torch.parallel.multihost import restart_scaling_efficiency

    return restart_scaling_efficiency(device="cpu", **inp)


def _rmse(model, dm, x_test, y_test):
    mean, _ = model.forward(dm, x_test)
    return float(np.sqrt(np.mean((mean.detach().numpy().ravel() - y_test.ravel()) ** 2)))


def task_trainers(inp, meshes):
    """`train_AR` (1-D and 2-D meshes), `train_NAR`, `train_CIGAR` and
    `train_GAR` with ``n_mesh`` and every stage sharded
    (``nshard_min_rows=1``), as `tests/test_trainer_nsharded.py` drives the
    JAX trainers; returns test RMSEs and relative errors."""
    from fidelityfusion_tpu_torch.models.ar import AR, train_AR
    from fidelityfusion_tpu_torch.models.cigar import CIGAR, train_CIGAR
    from fidelityfusion_tpu_torch.models.data_manager import MultiFidelityDataManager
    from fidelityfusion_tpu_torch.models.gar import GAR, train_GAR
    from fidelityfusion_tpu_torch.models.nar import NAR, train_NAR
    from fidelityfusion_tpu_torch.ops.kernels import ARDKernel, SquaredExponentialKernel

    def manager(pairs):
        return MultiFidelityDataManager([
            {"raw_fidelity_name": str(i), "fidelity_indicator": i, "X": x, "Y": y}
            for i, (x, y) in enumerate(pairs)])

    se = [SquaredExponentialKernel() for _ in range(3)]
    x_test, y_test = inp["toy_test"]
    out = {}
    for name, mesh in (("AR-n", meshes["n"]), ("AR-rn", meshes["rn"])):
        dm = manager(inp["toy_train"])
        model = AR(3, se, input_dim=1, device="cpu")
        train_AR(model, dm, max_iter=inp["iters"], lr_init=5e-2, n_restarts=4, n_mesh=mesh,
                 nshard_min_rows=1)
        out[name] = _rmse(model, dm, x_test, y_test)
    dm = manager(inp["toy_train"])
    model = NAR(3, se, input_dim=1, device="cpu")
    train_NAR(model, dm, max_iter=inp["iters"], lr_init=5e-2, n_restarts=4, n_mesh=meshes["n"],
              nshard_min_rows=1)
    out["NAR"] = _rmse(model, dm, x_test, y_test)

    x, ys = inp["fields"]
    for name in ("GAR", "CIGAR"):
        flat = name == "CIGAR"
        yy = [y.reshape(len(y), -1) if flat else y for y in ys]
        dm = manager([(x[:n], y[:n]) for y, n in zip(yy, (40, 32, 24))])
        shapes = [y.shape[1:] for y in ys]
        if flat:
            model = CIGAR(3, [ARDKernel() for _ in range(3)], shapes, input_dim=x.shape[1],
                          device="cpu")
            train_CIGAR(model, dm, max_iter=inp["field_iters"], lr_init=5e-2,
                        n_mesh=meshes["n"], nshard_min_rows=1)
        else:
            model = GAR(3, [ARDKernel() for _ in range(3)], shapes, input_dim=x.shape[1],
                        device="cpu")
            train_GAR(model, dm, max_iter=inp["field_iters"], lr_init=5e-2, n_mesh=meshes["n"],
                      nshard_min_rows=1)
        mean, var = model.forward(dm, x[40:])
        truth = yy[2][40:]
        out[name] = (float(np.linalg.norm(mean.detach().numpy() - truth) / np.linalg.norm(truth)),
                     var.detach().numpy())
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("inputs")
    ap.add_argument("out")
    ap.add_argument("tasks", nargs="+")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world-size", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)

    from fidelityfusion_tpu_torch.parallel import make_mesh, make_n_mesh, make_rn_mesh
    from fidelityfusion_tpu_torch.parallel.multihost import initialize_distributed

    initialize_distributed(f"localhost:{args.port}", args.world_size, args.rank, device="cpu")
    meshes = {"n": make_n_mesh(device="cpu"), "rn": make_rn_mesh(2, device="cpu"),
              "restart": make_mesh(device="cpu")}
    inputs = torch.load(args.inputs, weights_only=False)
    results, seconds = {}, {}
    for name in args.tasks:
        t = time.perf_counter()
        results[name] = globals()[f"task_{name}"](inputs.get(name), meshes)
        seconds[name] = time.perf_counter() - t
    results["seconds"] = seconds
    if args.rank == 0:
        torch.save(results, args.out)
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    main()
