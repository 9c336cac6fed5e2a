"""Whole GAR fits back to back (closed loop): ``train_GAR`` over ARD HOGP
stages on Poisson fields, then ``GAR.forward`` at the test inputs, the
result on the host.

Traffic keys: ``rows`` (nested training rows per fidelity, lowest first:
fidelity i on the first rows[i] samples), ``n_test``, ``steps``,
``restarts``, ``lr``, ``warm_steps``, ``init`` (the uniform ranges of each
stage's initial length scale ``ls``, signal variance ``sv`` and
``nv``, the HOGP's ``noise_variance``, whose inverse is the noise),
``checked`` (fits compared with the reference).  The configuration gives
``input_dim`` and ``fields`` (each fidelity's field shape).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from portbench import counts_gar
from portbench.data import poisson
from portbench.drivers import common
from portbench.reference import cigp
from portbench.reference import gar as ref

E2E = ("fit_s",)
CONTROL_CONFIG = {"tf32": True}  # the program with its TF32 path on
UNITS = {"fit_s": "s"}
TRAJ_STEPS = 4  # losses at the start and after each of the first three Adam steps


def design(run):
    """Nested training inputs uniform in [0, 1]^d (fidelity i: the first
    rows[i]) and their fields at each fidelity's resolution, and the test
    inputs, from the seed."""
    tr, cfg = run.traffic, run.config
    d = cfg["input_dim"]
    x = common.rng(run.seed, 1).random((tr["rows"][0], d))
    xs = [x[:n] for n in tr["rows"]]
    ys = [poisson.fields(xi, shape[0]) for xi, shape in zip(xs, cfg["fields"])]
    x_test = common.rng(run.seed, 2).random((tr["n_test"], d))
    return xs, ys, x_test


def init_params(run, i: int):
    """Each stage's initial (ls, sv, nv), drawn from the seed and the fit's
    index."""
    lo_hi = run.traffic["init"]
    r = common.rng(run.seed, 3, i + 1)
    return [{k: float(r.uniform(*lo_hi[k])) for k in ("ls", "sv", "nv")}
            for _ in run.traffic["rows"]]


def setup(run):
    xs, ys, x_test = design(run)
    state = {"xs": xs, "ys": ys, "x_test": x_test,
             "shapes": [tuple(s) for s in run.config["fields"]]}
    fit(run, state, -1, steps=run.traffic["warm_steps"])  # builds and warms this cell's shapes
    return state


def model_of(run, state):
    from fidelityfusion_tpu_torch.models.gar import GAR
    from fidelityfusion_tpu_torch.ops.kernels import ARDKernel

    nf = len(state["xs"])
    return GAR(nf, [ARDKernel() for _ in range(nf)], state["shapes"],
               input_dim=run.config["input_dim"], device=run.device)


def fit(run, state, i: int, steps: int):
    from fidelityfusion_tpu_torch.models.data_manager import MultiFidelityDataManager
    from fidelityfusion_tpu_torch.models.gar import train_GAR

    tr, dev = run.traffic, run.device
    inits = init_params(run, i)
    t0 = time.time()
    dm = MultiFidelityDataManager([
        {"raw_fidelity_name": str(f), "fidelity_indicator": f, "X": x, "Y": y}
        for f, (x, y) in enumerate(zip(state["xs"], state["ys"]))])
    model = model_of(run, state)
    for s, p in enumerate(inits):
        model.params["hogp"][s] = {
            "kernel": {"length_scales": torch.tensor([p["ls"]], device=dev),
                       "signal_variance": torch.tensor([p["sv"]], device=dev)},
            "noise_variance": torch.tensor([p["nv"]], device=dev)}
    clock = common.StageClock(run, t0)
    hists = train_GAR(model, dm, max_iter=steps, lr_init=tr["lr"], n_restarts=tr["restarts"],
                      debugger=clock)
    with run.span("forward"), torch.no_grad():
        mean, var = model.forward(dm, state["x_test"].astype(np.float32))
        mean, var = mean.cpu().numpy(), var.cpu().numpy()
    wall = time.time() - t0
    return {"wall": wall, "stage_s": clock.stage_s, "hists": hists, "inits": inits,
            "params": model.params, "dm": dm, "mean": mean, "var": var}


def unit(run, state, i):
    return fit(run, state, i, run.traffic["steps"])


def _spectral_counters():
    """``(read, reset)`` of the program's tracked-spectrum counters
    (`ops/spectral.py`), each None where the program has none."""
    from fidelityfusion_tpu_torch.ops import spectral

    return (getattr(spectral, "spectral_counts", None),
            getattr(spectral, "reset_spectral_counts", None))


def traced(run, state):
    """One fit; the spectrum's counts of it (where the program counts) go
    to ``run.traced_fit`` for the metric readers."""
    read, reset = _spectral_counters()
    if reset is not None:
        reset()
    fit(run, state, 10 ** 6, run.traffic["steps"])
    run.traced_fit = {"spectral": read() if read else None}
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
    return counts_gar.gar_fit_flops(tr["rows"], cfg["fields"], cfg["input_dim"], tr["restarts"],
                                    tr["steps"], tr["n_test"])


def _port_nlls(run, state, rec):
    """Each stage's NLML by the program's exact path (`HOGP.nll`: float64
    Grams, exact ``eigh``) at its trained parameters, on its stage data."""
    model = model_of(run, state)
    out = []
    with torch.no_grad():
        for i, hogp in enumerate(model.hogp_list):
            x, y, y_var = model._stage_train_data(rec["dm"], i)
            out.append(float(hogp.nll(rec["params"]["hogp"][i], x, y, y_var)))
    return out


def _stage_params(params):
    out = []
    for s, hp in enumerate(params["hogp"]):
        p = {"ls": float(hp["kernel"]["length_scales"][0]),
             "sv": float(hp["kernel"]["signal_variance"][0]),
             "nv": float(hp["noise_variance"][0])}
        if s > 0:
            p.update({f"m{k}": M.detach().cpu().numpy().astype(np.float64)
                      for k, M in enumerate(params["tl"][s - 1]["maps"])})
        out.append(p)
    return out


def _to_host(run, state, rec):
    return {"hists": [h.detach().cpu().numpy().astype(np.float64) for h in rec["hists"]],
            "params": _stage_params(rec["params"]), "inits": rec["inits"],
            "nll": _port_nlls(run, state, rec), "mean": rec["mean"], "var": rec["var"]}


def check(run, state):
    """The sampled fits against the float64 reference on the card.  From
    the window's own output: each stage's loss at step 0 from the same
    restarts (``step0``; an exact ``eigh`` on both sides, the rest of the
    program's NLML in float32), each stage's losses after its first three
    Adam steps (``traj_s<i>``; the program's steps are tracked, so this
    holds the tracking's error, each stage under its own limit), and the
    cascade's posterior at the test inputs (``mean`` in units of the top
    fidelity's field std, ``var`` of its square).  Recomputed after the
    window: each stage's NLML at the program's trained parameters by the
    program's exact path and by the reference (``nll``).  Every loss is
    per element, as the NLML is."""
    picks = common.sample(run.seed, len(run.records), run.traffic["checked"])
    recs = [_to_host(run, state, run.records[i]) for i in picks]
    run.records.clear()
    torch.cuda.empty_cache()
    return compare(run, state, recs)


def compare(run, state, recs):
    tr, device = run.traffic, run.device
    data = ref.GARData(state["xs"], state["ys"])
    y_std = data.norms[-1].y_std
    stages = range(len(tr["rows"]))
    gaps = dict.fromkeys(["step0", *(f"traj_s{s}" for s in stages), "nll", "mean", "var"], 0.0)
    with ref.no_tf32():
        for rec in recs:
            for s in stages:
                args = ref.stage_args(data, s, device)
                p0 = dict(rec["inits"][s])
                if s > 0:
                    p0.update({f"m{k}": M for k, M in enumerate(data.initial_maps(s))})
                batch = ref.restart_batch(p0, args["x"].cpu().numpy(), tr["restarts"], device)
                losses, _ = cigp.adam(lambda p: ref.stage_loss(p, **args), batch, TRAJ_STEPS,
                                     tr["lr"])
                losses = losses.cpu().numpy()
                h = rec["hists"][s]
                gaps["step0"] = max(gaps["step0"], common.rel_gap(h[:, 0], losses[:, 0], 1.0))
                gaps[f"traj_s{s}"] = max(gaps[f"traj_s{s}"],
                                         common.rel_gap(h[:, 1:TRAJ_STEPS], losses[:, 1:], 1.0))
                with torch.no_grad():
                    final_ref = float(ref.stage_loss(ref.stage_params(rec["params"][s], device),
                                                     **args)[0])
                gaps["nll"] = max(gaps["nll"], common.rel_gap(rec["nll"][s], final_ref, 1.0))
            with torch.no_grad():
                m, v = ref.gar_posterior(data, rec["params"], state["x_test"], device)
            gaps["mean"] = max(gaps["mean"], common.rel_gap(rec["mean"], m.cpu().numpy(), y_std))
            gaps["var"] = max(gaps["var"], common.rel_gap(rec["var"], v.cpu().numpy(),
                                                          y_std ** 2))
    return [(f"{k}_gap", v) for k, v in gaps.items()]
