"""Whole CAR-large fits back to back (closed loop): ``train_CAR_large``, one
unbatched joint GP over every fidelity's rows stacked, then
``ContinuousAutoRegressionLarge.forward`` at the test points, the mean and
the variance on the host.

Traffic keys: ``rows`` (nested training rows per fidelity, lowest first,
the design of `fit_ar.design`), ``n_test``, ``steps``, ``lr``,
``warm_steps``, ``init`` (the uniform ranges of the initial base length
scales ``ls``, ``length_scale_z`` ``lz``, signal variance ``sv`` and
``b``; the noise starts at 1), ``checked`` (fits compared with the
reference).  The configuration gives ``input_dim``.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from portbench import counts_car
from portbench.drivers import common, fit_ar
from portbench.reference import car as ref
from portbench.reference import cigp
from portbench.reference.gar import no_tf32

E2E = ("fit_s",)
CONTROL_CONFIG = {"tf32": True}  # the program with its TF32 path on
UNITS = {"fit_s": "s"}
TRAJ_STEPS = 4  # losses at the start and after each of the first three Adam steps


def init_params(run, i: int) -> dict:
    """The fit's initial kernel parameters, drawn from the seed and the
    fit's index: one base length scale per input, ``lz``, ``sv``, ``b``."""
    lo_hi, d = run.traffic["init"], run.config["input_dim"]
    r = common.rng(run.seed, 3, i + 1)
    return {"ls": [float(v) for v in r.uniform(*lo_hi["ls"], size=d)],
            **{k: float(r.uniform(*lo_hi[k])) for k in ("lz", "sv", "b")}}


def setup(run):
    xs, ys, x_test = fit_ar.design(run)
    state = {"xs": xs, "ys": ys, "x_test": x_test.astype(np.float32)}
    fit(run, state, -1, steps=run.traffic["warm_steps"])  # builds and warms this cell's shapes
    return state


def fit(run, state, i: int, steps: int):
    from fidelityfusion_tpu_torch.models.car import ContinuousAutoRegressionLarge, train_CAR_large
    from fidelityfusion_tpu_torch.models.data_manager import MultiFidelityDataManager
    from fidelityfusion_tpu_torch.ops.kernels import ARDKernel

    dev, init = run.device, init_params(run, i)
    t0 = time.time()
    dm = MultiFidelityDataManager([
        {"raw_fidelity_name": str(f), "fidelity_indicator": f, "X": x, "Y": y}
        for f, (x, y) in enumerate(zip(state["xs"], state["ys"]))])
    model = ContinuousAutoRegressionLarge(len(state["xs"]), ARDKernel(),
                                          input_dim=run.config["input_dim"], device=dev)
    k = model.params["kernel"]
    k["base"]["length_scales"] = torch.tensor(init["ls"], device=dev)
    k["length_scale_z"] = torch.tensor([init["lz"]], device=dev)
    k["signal_variance"] = torch.tensor([init["sv"]], device=dev)
    k["b"] = torch.tensor(init["b"], device=dev)
    clock = common.StageClock(run, time.time())
    hist = train_CAR_large(model, dm, max_iter=steps, lr_init=run.traffic["lr"], debugger=clock)
    with run.span("forward"), torch.no_grad():
        mean, cov = model.forward(dm, state["x_test"])
        mean, var = mean.reshape(-1).cpu().numpy(), cov.diagonal().cpu().numpy()
    wall = time.time() - t0
    return {"wall": wall, "stage_s": clock.stage_s, "hist": hist, "init": init,
            "params": model.params, "mean": mean, "var": var}


def unit(run, state, i):
    return fit(run, state, i, run.traffic["steps"])


def traced(run, state):
    """One fit; its CAR-large counts and the kernel wrappers' launches go
    to ``run.traced_fit``."""
    from fidelityfusion_tpu_torch.models.car import car_counts, reset_car_counts
    from fidelityfusion_tpu_torch.ops import cuda

    reset_car_counts()
    before = cuda.launch_counts()
    fit(run, state, 10 ** 6, run.traffic["steps"])
    launches = {k: v - before.get(k, 0) for k, v in cuda.launch_counts().items()}
    run.traced_fit = {"car": car_counts(), "launches": launches}
    print(f"portbench: traced fit counts {run.traced_fit}", file=sys.stderr)
    return 1


def end_to_end(run, state):
    walls = " ".join(f"{r['wall']:.3f}" for r in run.records)
    print(f"portbench: fit walls in window order (s): {walls}", file=sys.stderr)
    return {"fit_s": run.window_s / len(run.records)}


def attempted_failed(run):
    bad = sum(1 for r in run.records
              if not (np.all(np.isfinite(r["mean"])) and np.all(np.isfinite(r["var"]))))
    return len(run.records), bad


def flops_per_fit(run) -> float:
    tr, cfg = run.traffic, run.config
    return counts_car.car_fit_flops(tr["rows"], cfg["input_dim"], cfg["n_features"], cfg["n_mc"],
                                    tr["steps"], tr["n_test"])


def _to_host(rec):
    k = rec["params"]["kernel"]
    host = lambda a: a.detach().cpu().numpy().astype(np.float64)  # noqa: E731
    trained = {"ls": host(k["base"]["length_scales"]),
               "sv_x": host(k["base"]["signal_variance"][0]),
               "lz": host(k["length_scale_z"][0]), "sv": host(k["signal_variance"][0]),
               "b": host(k["b"]), "nv": host(rec["params"]["noise_variance"][0])}
    return {"hist": host(rec["hist"]), "init": rec["init"], "trained": trained,
            "mean": rec["mean"], "var": rec["var"]}


def check(run, state):
    """The sampled fits against the float64 reference on the card, every
    loss per stacked row: the NLML at the fit's initial parameters
    (``step0``), the losses after each of its first three Adam steps
    (``traj``), the last loss of the fit against the reference's NLML at
    the trained parameters (``nll``), and the posterior at the test points
    (``mean`` in units of the top fidelity's y std, ``var`` of its
    square).  The reference makes its own Monte-Carlo draws from the
    configuration's ``mc_seed``."""
    picks = common.sample(run.seed, len(run.records), run.traffic["checked"])
    recs = [_to_host(run.records[i]) for i in picks]
    run.records.clear()
    torch.cuda.empty_cache()
    return compare(run, state, recs)


def compare(run, state, recs):
    lr, device = run.traffic["lr"], run.device
    data = ref.CARData(state["xs"], state["ys"])
    x, y = (torch.as_tensor(a, device=device) for a in (data.x, data.y))
    xt = torch.as_tensor(data.test_inputs(state["x_test"].astype(np.float64)), device=device)
    n, y_std = len(data.x), data.norms[-1].y_std
    cfg = run.config
    w, t = (a.to(device) for a in ref.draws(cfg["mc_seed"], cfg["n_features"], cfg["n_mc"]))
    gaps = dict.fromkeys(["step0", "traj", "nll", "mean", "var"], 0.0)
    with no_tf32():
        for rec in recs:
            p0 = ref.params({**rec["init"], "sv_x": 1.0, "nv": 1.0}, device)
            losses, _ = cigp.adam(lambda p: ref.nll(p, x, y, w, t), p0, TRAJ_STEPS, lr)
            losses, h = losses.cpu().numpy(), rec["hist"]
            gaps["step0"] = max(gaps["step0"], common.rel_gap(h[0], losses[0], n))
            gaps["traj"] = max(gaps["traj"], common.rel_gap(h[1:TRAJ_STEPS], losses[1:], n))
            p = ref.params(rec["trained"], device)
            with torch.no_grad():
                final_ref = float(ref.nll(p, x, y, w, t))
                m, v = ref.posterior(p, x, y, xt, w, t)
            finite = h[np.isfinite(h)]
            final = finite[-1] if finite.size else float("nan")
            gaps["nll"] = max(gaps["nll"], common.rel_gap(final, final_ref, n))
            nm = data.norms[-1]
            m = m.cpu().numpy() * nm.y_std + nm.y_mean
            v = v.cpu().numpy() * nm.y_std ** 2
            gaps["mean"] = max(gaps["mean"], common.rel_gap(rec["mean"], m, y_std))
            gaps["var"] = max(gaps["var"], common.rel_gap(rec["var"], v, y_std ** 2))
    return [(f"{k}_gap", v) for k, v in gaps.items()]
