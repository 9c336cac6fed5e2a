"""One closed-loop client querying a trained AR cascade: each query asks
the top fidelity's posterior mean and diagonal variance
(``ARPosterior.__call__``, ``diag=True``) at b raw points of the p4 domain
and ends when the result is on the host.

Set-up trains the cascade of the ``fit`` traffic's design once from the
seed and exports its posterior: set-up the traffic needs.  Traffic keys:
those of the fit mix (``rows``, ``steps``, ``restarts``, ``lr``, ``init``),
``sizes`` (the points b of a query, in equal shares), ``pool`` (queries
drawn from the seed and sent in turn), ``warm`` (queries of the pool sent
in set-up), ``traced`` (queries under the profiler), ``checked`` (queries
compared).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.data import zoo
from portbench.drivers import common, fit_ar
from portbench.reference import cigp as ref

E2E = ("query_p95_ms",)
CONTROL_CONFIG = {"tf32": True}  # the program with its TF32 path on
UNITS = {"query_p95_ms": "ms"}


def pool(run):
    """The queries' points, each (b, 2) float32.  Every seed sends the
    same sizes, each of ``sizes`` in equal shares, in an order and at
    points drawn from the seed."""
    tr = run.traffic
    sizes = np.resize(np.asarray(tr["sizes"], dtype=int), tr["pool"])
    r = common.rng(run.seed, 11)
    return [zoo.uniform(r, int(k)).astype(np.float32) for k in r.permutation(sizes)]


def setup(run):
    from fidelityfusion_tpu_torch.models.ar import AR, train_AR
    from fidelityfusion_tpu_torch.models.data_manager import MultiFidelityDataManager
    from fidelityfusion_tpu_torch.ops.kernels import SquaredExponentialKernel

    tr, dev = run.traffic, run.device
    xs, ys, _ = fit_ar.design(run)
    dm = MultiFidelityDataManager([
        {"raw_fidelity_name": str(f), "fidelity_indicator": f, "X": x, "Y": y}
        for f, (x, y) in enumerate(zip(xs, ys))])
    nf = len(xs)
    model = AR(nf, [SquaredExponentialKernel() for _ in range(nf)], input_dim=2, device=dev)
    for s, p in enumerate(fit_ar.init_params(run, -2)):
        model.params["gp"][s] = {
            "kernel": {"length_scale": torch.tensor([p["t"]], device=dev),
                       "signal_variance": torch.tensor([p["u"]], device=dev)},
            "log_beta": torch.tensor([p["b"]], device=dev)}
    train_AR(model, dm, max_iter=tr["steps"], lr_init=tr["lr"], n_restarts=tr["restarts"])
    post, st = model.export_posterior(dm, diag=True)
    state = {"xs": xs, "ys": ys, "post": post, "st": st, "pool": pool(run),
             "params": fit_ar._stage_params({"gp": model.params["gp"],
                                             "rho": model.params["rho"]}),
             "outputs": {}}
    for q in state["pool"][: tr["warm"]]:
        query(state, q)
    return state


def query(state, x):
    mean, var = state["post"](state["st"], x)
    return mean.cpu().numpy(), var.cpu().numpy()


def unit(run, state, i):
    k = i % len(state["pool"])
    t0 = time.perf_counter()
    mean, var = query(state, state["pool"][k])
    lat = time.perf_counter() - t0
    if i < len(state["pool"]):
        state["outputs"][k] = (mean, var)
    return {"lat": lat, "finite": bool(np.isfinite(mean).all() and np.isfinite(var).all())}


def traced(run, state):
    n = run.traffic["traced"]
    for i in range(n):
        with run.span("query"):
            query(state, state["pool"][i % len(state["pool"])])
    return n


def end_to_end(run, state):
    lat = np.array([r["lat"] for r in run.records])
    return {"query_p95_ms": 1e3 * float(np.percentile(lat, 95))}


def attempted_failed(run):
    return len(run.records), sum(1 for r in run.records if not r["finite"])


def check(run, state):
    """A sample of the window's queries, the largest among them, against
    the float64 cascade posterior worked out from the exported stages'
    parameters and the training data: ``mean_gap`` in units of the top
    fidelity's y std, ``var_gap`` of its square."""
    done = sorted(state["outputs"])
    r = common.rng(run.seed, 12)
    pick = set(r.choice(done, min(run.traffic["checked"], len(done)), replace=False).tolist())
    pick.add(max(done, key=lambda k: len(state["pool"][k])))
    outs = {k: state["outputs"][k] for k in pick}
    state.pop("post"), state.pop("st")
    torch.cuda.empty_cache()
    return compare(run, state, outs)


def compare(run, state, outs):
    keys = sorted(outs)
    data = ref.ARData(state["xs"], state["ys"])
    y_std = data.norms[-1].y_std
    pts = np.concatenate([state["pool"][k] for k in keys]).astype(np.float64)
    with torch.no_grad():
        m, v = ref.ar_posterior(data, state["params"], pts, torch.float64, run.device)
    m, v = m.cpu().numpy(), v.cpu().numpy()
    m_port = np.concatenate([outs[k][0].reshape(-1) for k in keys])
    v_port = np.concatenate([outs[k][1].reshape(-1) for k in keys])
    return [("mean_gap", common.rel_gap(m_port, m, y_std)),
            ("var_gap", common.rel_gap(v_port, v, y_std ** 2))]

