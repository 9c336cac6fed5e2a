"""Whole AR cascade fits back to back (closed loop): ``train_AR`` over
CIGP stages with the SE kernel, then ``export_posterior`` and the top
fidelity's posterior at the test points, the result on the host.

Traffic keys: ``rows`` (nested training rows per fidelity, lowest first),
``n_test``, ``steps``, ``restarts``, ``lr``, ``warm_steps``, ``init`` (the
uniform ranges of each stage's initial ``t``, ``u``, ``b``), ``checked``
(fits compared with the reference).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import counts
from portbench.data import zoo
from portbench.drivers import common
from portbench.reference import cigp as ref

E2E = ("fit_s",)
CONTROL_CONFIG = {"tf32": True}  # the program with its TF32 path on
UNITS = {"fit_s": "s"}
TRAJ_STEPS = 4  # losses at the start and after each of the first three Adam steps


def design(run):
    """Nested training inputs (fidelity i: the first rows[i] rows) and the
    test points, from the seed; targets from the p4 functions."""
    tr = run.traffic
    r = common.rng(run.seed, 1)
    x = zoo.uniform(r, tr["rows"][0])
    ys_all = zoo.p4(x)
    xs = [x[:n] for n in tr["rows"]]
    ys = [ys_all[i][:n] for i, n in enumerate(tr["rows"])]
    x_test = zoo.uniform(common.rng(run.seed, 2), tr.get("n_test", 0))
    return xs, ys, x_test


def init_params(run, i: int):
    """Each stage's initial (t, u, b), drawn from the seed and the fit's
    index."""
    lo_hi = run.traffic["init"]
    r = common.rng(run.seed, 3, i + 1)
    return [{k: float(r.uniform(*lo_hi[k])) for k in ("t", "u", "b")}
            for _ in run.traffic["rows"]]


def setup(run):
    xs, ys, x_test = design(run)
    state = {"xs": xs, "ys": ys, "x_test": x_test.astype(np.float32)}
    fit(run, state, -1, steps=run.traffic["warm_steps"])  # builds and warms this cell's shapes
    return state


def fit(run, state, i: int, steps: int):
    from fidelityfusion_tpu_torch.models.ar import AR, train_AR
    from fidelityfusion_tpu_torch.models.data_manager import MultiFidelityDataManager
    from fidelityfusion_tpu_torch.ops.kernels import SquaredExponentialKernel

    tr, dev = run.traffic, run.device
    inits = init_params(run, i)
    t0 = time.time()
    dm = MultiFidelityDataManager([
        {"raw_fidelity_name": str(f), "fidelity_indicator": f, "X": x, "Y": y}
        for f, (x, y) in enumerate(zip(state["xs"], state["ys"]))])
    nf = len(state["xs"])
    model = AR(nf, [SquaredExponentialKernel() for _ in range(nf)], input_dim=2, device=dev)
    for s, p in enumerate(inits):
        model.params["gp"][s] = {
            "kernel": {"length_scale": torch.tensor([p["t"]], device=dev),
                       "signal_variance": torch.tensor([p["u"]], device=dev)},
            "log_beta": torch.tensor([p["b"]], device=dev)}
    clock = common.StageClock(run, t0)
    hists = train_AR(model, dm, max_iter=steps, lr_init=tr["lr"], n_restarts=tr["restarts"],
                     debugger=clock)
    with run.span("export"):
        post, st = model.export_posterior(dm)
        mean, var = post(st, state["x_test"])
        mean, var = mean.cpu().numpy(), var.cpu().numpy()
    wall = time.time() - t0
    return {"wall": wall, "stage_s": clock.stage_s, "hists": hists, "inits": inits,
            "gp": model.params["gp"], "rho": model.params["rho"], "mean": mean, "var": var}


def unit(run, state, i):
    return fit(run, state, i, run.traffic["steps"])


def traced(run, state):
    fit(run, state, 10 ** 6, run.traffic["steps"])
    return 1


def end_to_end(run, state):
    return {"fit_s": run.window_s / len(run.records)}


def attempted_failed(run):
    bad = sum(1 for r in run.records
              if not (np.all(np.isfinite(r["mean"])) and np.all(np.isfinite(r["var"]))))
    return len(run.records), bad


def flops_per_fit(run) -> float:
    tr = run.traffic
    return counts.ar_fit_flops(tr["rows"], 2, tr["restarts"], tr["steps"], tr["n_test"])


def _stage_params(rec):
    out = []
    for s, gp in enumerate(rec["gp"]):
        p = {"t": float(gp["kernel"]["length_scale"][0]),
             "u": float(gp["kernel"]["signal_variance"][0]), "b": float(gp["log_beta"][0])}
        if s > 0:
            p["rho"] = float(rec["rho"][s - 1])
        out.append(p)
    return out


def _to_host(rec):
    return {**rec, "hists": [h.detach().cpu().numpy().astype(np.float64) for h in rec["hists"]],
            "params": _stage_params(rec), "gp": None, "rho": None}


def _loss_in(dtype, p, args) -> float:
    """The reference's stage NLML computed wholly in ``dtype`` (inf where
    its Cholesky fails)."""
    cast = {k: (v.to(dtype) if torch.is_tensor(v) else v) for k, v in args.items()}
    try:
        return float(ref.stage_loss({k: v.to(dtype) for k, v in p.items()}, **cast))
    except torch.linalg.LinAlgError:
        return float("inf")


def check(run, state):
    """The sampled fits against the float64 reference on the card: each
    stage's losses over the first Adam steps from the same restarts
    (``traj``), its final NLML at the port's trained parameters (``nll``),
    both per training row, and the posterior at the test points
    (``mean`` in units of the top fidelity's y std, ``var`` of its
    square).  Printed beside them, not compared: ``nll_f32_held``, how far
    the float64 NLML at the same parameters moves, per row, when only
    Sigma and the targets are rounded to float32, the part of ``nll_gap``
    that no float32 program can avoid; ``nll_f32_ref``, the same reference
    computed wholly in float32, a second float32 witness."""
    picks = common.sample(run.seed, len(run.records), run.traffic["checked"])
    recs = [_to_host(run.records[i]) for i in picks]
    run.records.clear()
    torch.cuda.empty_cache()
    return compare(run, state, recs)


def compare(run, state, recs):
    tr, dtype, device = run.traffic, torch.float64, run.device
    data = ref.ARData(state["xs"], state["ys"])
    y_std = data.norms[-1].y_std
    gaps = {"traj": 0.0, "nll": 0.0, "mean": 0.0, "var": 0.0, "nll_f32_held": 0.0,
            "nll_f32_ref": 0.0}
    T = lambda a: ref.to_t(a, dtype, device)  # noqa: E731
    for rec in recs:
        for s in range(len(tr["rows"])):
            if s == 0:
                x, y = data.stage0()
                args = dict(x=T(x), y=T(y))
            else:
                x, yl, yh, shift, scale = data.subset_stage(s)
                args = dict(x=T(x), y=T(yh), yl=T(yl), shift=shift, scale=scale)
            n = x.shape[0]
            p0 = dict(rec["inits"][s])
            if s > 0:
                p0["rho"] = 1.0
            batch = ref.restart_batch(p0, x, tr["restarts"], dtype, device)
            losses, _ = ref.adam(lambda p: ref.stage_loss(p, **args), batch, TRAJ_STEPS, tr["lr"])
            h = rec["hists"][s]
            gaps["traj"] = max(gaps["traj"], common.rel_gap(
                h[:, :TRAJ_STEPS], losses.cpu().numpy(), n))
            p = {k: torch.tensor(v, dtype=dtype, device=device)
                 for k, v in rec["params"][s].items()}
            with torch.no_grad():
                final_ref = float(ref.stage_loss(p, **args))
                held = float(ref.stage_loss(p, **args, held_in=torch.float32))
                f32 = _loss_in(torch.float32, p, args)
            gaps["nll_f32_held"] = max(gaps["nll_f32_held"], abs(held - final_ref) / n)
            gaps["nll_f32_ref"] = max(gaps["nll_f32_ref"], abs(f32 - final_ref) / n)
            finite = [row[np.isfinite(row)][-1] for row in h if np.isfinite(row).any()]
            final = min(finite) if finite else float("nan")
            gaps["nll"] = max(gaps["nll"], common.rel_gap(final, final_ref, n))
        with torch.no_grad():
            m, v = ref.ar_posterior(data, rec["params"], state["x_test"].astype(np.float64),
                                    dtype, device)
        gaps["mean"] = max(gaps["mean"], common.rel_gap(rec["mean"].reshape(-1),
                                                        m.cpu().numpy(), y_std))
        gaps["var"] = max(gaps["var"], common.rel_gap(rec["var"].reshape(-1),
                                                      v.cpu().numpy(), y_std ** 2))
    return ([(f"{k}_gap", gaps[k]) for k in ("traj", "nll", "mean", "var")]
            + [(k, gaps[k]) for k in ("nll_f32_held", "nll_f32_ref")])

