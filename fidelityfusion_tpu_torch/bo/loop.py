"""Discrete multi-fidelity Bayesian optimization: the outer loop.

Port of `fidelityfusion_tpu/bo/loop.py`: initial design -> fit the MF
surrogate -> maximize the acquisition over (x, fidelity) -> query the
objective at (x, s) -> append -> record {cost, incumbent, time}.  The
surrogate (AR, ResGP or NAR over SE CIGPs, non-subset) is rebuilt and
retrained from scratch each iteration through the port's kernels (K1,
K3a, K3b); each stage's factorization is exported once per iteration
(K2, K3b) and the acquisition ascends through K1's cross-Gram and its
x-gradient.

Random draws come from CPU ``torch.Generator``s, one per (seed,
iteration, fidelity), so a resumed loop draws what the uninterrupted one
would, and one seed gives the same starts on the CPU and on the card.
"""

from __future__ import annotations

import math
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from fidelityfusion_tpu_torch.bo.mf_acq import MFAcqScore
from fidelityfusion_tpu_torch.bo.optimize import optimize_acqf
from fidelityfusion_tpu_torch.models.ar import AR, train_AR
from fidelityfusion_tpu_torch.models.data_manager import MultiFidelityDataManager
from fidelityfusion_tpu_torch.models.nar import NAR, train_NAR
from fidelityfusion_tpu_torch.models.resgp import ResGP, train_ResGP
from fidelityfusion_tpu_torch.ops.kernels import SquaredExponentialKernel
from fidelityfusion_tpu_torch.utils.checkpoint import load_bo_state, save_bo_state
from fidelityfusion_tpu_torch.utils.device import resolve_device, synced_time

MODEL_REGISTRY = {
    "AR": (AR, train_AR),
    "ResGP": (ResGP, train_ResGP),
    "NAR": (NAR, train_NAR),
}


def generator(seed: int, *salt: int) -> torch.Generator:
    """A CPU generator of its own for ``(seed, *salt)``."""
    state = np.random.SeedSequence([seed, *salt]).generate_state(1)[0]
    return torch.Generator().manual_seed(int(state))


def fit_surrogate(objective, xs, ys, model_name: str = "AR", train_iters: int = 100,
                  train_lr: float = 5e-2, device="cuda"):
    """The iteration's surrogate, built anew and trained on the current
    datasets (non-subset, SE kernels; AR pads its stages to multiples of
    16 as the JAX loop does).  Returns ``(model, data_manager)``."""
    fidelity_num = objective.total_fidelity_num
    dm = MultiFidelityDataManager([
        {"raw_fidelity_name": str(i), "fidelity_indicator": i, "X": xs[i], "Y": ys[i]}
        for i in range(fidelity_num)])
    cls, train_fn = MODEL_REGISTRY[model_name]
    model = cls(fidelity_num, [SquaredExponentialKernel() for _ in range(fidelity_num)],
                if_nonsubset=True, input_dim=objective.x_dim, device=device)
    extra = {"pad_multiple": 16} if model_name == "AR" else {}
    train_fn(model, dm, max_iter=train_iters, lr_init=train_lr, **extra)
    return model, dm


def acquire(model, dm, method: str, beta: float, f_best: float, bounds,
            gamma: Sequence[float], acq_iterations: int = 30, acq_lr: float = 0.1,
            generators: Optional[Sequence[torch.Generator]] = None,
            starts: Optional[Sequence] = None):
    """The cached acquisition step: each fidelity's posterior exported once
    (`export_posterior(pad_multiple=16)`), its score ascended by 16-start
    Adam (starts from ``generators[s]``, or ``starts[s]``), the best x over
    the fidelities, then the MF-GP-UCB gate: the lowest fidelity s with
    beta * var_s(x) > gamma[s] in the normalized-y space, else the top.

    UCB is scored in the normalized-y space as well (the reference
    maximizes there); the other methods in raw y.  Returns ``(new_x (1, d)
    float32 numpy, new_s, best value, [(score, state) per fidelity])``."""
    fidelity_num = model.fidelity_num
    f_best_t = torch.tensor(f_best, dtype=torch.float32, device=model.device)
    scores, best_xs, best_vs = [], [], []
    for s in range(fidelity_num):
        post, state = model.export_posterior(dm, to_fidelity=s, pad_multiple=16)
        if method == "UCB":
            score = MFAcqScore(post, method=method, beta=beta,
                               y_shift=float(state["y_norm"][0]),
                               y_scale=float(state["y_norm"][1]))
        else:
            score = MFAcqScore(post, method=method, beta=beta)
        x_s, v_s = optimize_acqf(
            score, bounds, generators[s] if generators is not None else None,
            raw_samples=16, steps=acq_iterations, lr=acq_lr, acq_args=(state, f_best_t),
            x0=starts[s] if starts is not None else None, device=model.device)
        scores.append((score, state))
        best_xs.append(x_s)
        best_vs.append(float(v_s))
    best = int(np.argmax(best_vs))
    new_x = best_xs[best].detach().reshape(1, -1).cpu().numpy()
    new_s = fidelity_num - 1
    with torch.no_grad():
        for s, (score, state) in enumerate(scores):
            _, v = score.posterior(state, torch.as_tensor(new_x, device=model.device))
            y_std = float(state["y_norm"][1])
            if beta * float(v.max()) / (y_std * y_std + 1e-12) > gamma[s]:
                new_s = s
                break
    return new_x, new_s, best_vs[best], scores


def _cross_scale(model, s: int, fidelity_num: int) -> float:
    """c with cov(f_top(x'), f_s(x)) = c cov_s(x', x): the product of rho_j
    for j >= s in a rho-residual cascade (AR); 1 without rho (ResGP, NAR:
    treated as perfectly coupled)."""
    rhos = model.params.get("rho")
    if not rhos:
        return 1.0
    prod = 1.0
    for j in range(s, fidelity_num - 1):
        prod *= float(rhos[j])
    return prod


def _strategy_step(objective, model, dm, method, it, bo_iterations, seed, bounds, ys,
                   cost_budget):
    """One ES or cfKG step (`bo/strategies.py`) over the surrogate's
    `forward` posteriors."""
    from fidelityfusion_tpu_torch.bo.strategies import CFKGStrategy, MFESStrategy

    fidelity_num = objective.total_fidelity_num

    def posterior_fn(x, s):
        with torch.no_grad():
            m, c = model.forward(dm, x, to_fidelity=s)
        v = torch.diagonal(c) if c.ndim == 2 else c
        return m.reshape(-1), v.reshape(-1)

    def cov_full_fn(x, s):
        with torch.no_grad():
            _, c = model.forward(dm, x, to_fidelity=s)
        return c if c.ndim == 2 else torch.diag(c.reshape(-1))

    def cost_fn(s1):
        return float(objective.cost.compute_cost(s1))

    def cross_scale_fn(s):
        return _cross_scale(model, s, fidelity_num)

    is_last = it == bo_iterations - 1
    if cost_budget is not None and not is_last:
        # budget-aware cash-in: once the remaining budget covers at most two
        # more top-fidelity queries, query the top-fidelity posterior argmax
        spent = float(objective.cost.compute_model_cost(ys))
        top_cost = float(objective.cost.compute_cost(fidelity_num))
        is_last = (cost_budget - spent) <= 2.0 * top_cost
    if method == "ES":
        strat = MFESStrategy(objective.x_dim, fidelity_num, posterior_fn, cost_fn=cost_fn,
                             cross_scale_fn=cross_scale_fn, seed=seed + 31 * it,
                             is_last=is_last, bounds=bounds, device=model.device)
    else:
        strat = CFKGStrategy(objective.x_dim, fidelity_num,
                             lambda x, s: posterior_fn(x, s)[0], cov_full_fn,
                             cost_fn=cost_fn, incumbent=float(np.max(ys[-1])),
                             cross_scale_fn=cross_scale_fn, seed=seed + 77 * it,
                             bounds=bounds, n_candidates=64, is_last=is_last,
                             device=model.device)
    new_x, new_s = strat.compute_next()
    return np.asarray(new_x, np.float32).reshape(1, -1), int(new_s)


def mf_bo_discrete(objective, method: str = "UCB", model_name: str = "AR",
                   bo_iterations: int = 10, init_index: Optional[Dict[int, int]] = None,
                   seed: int = 0, train_iters: int = 100, train_lr: float = 5e-2,
                   acq_iterations: int = 30, acq_lr: float = 0.1,
                   gamma: Optional[List[float]] = None, verbose: bool = False,
                   checkpoint_path: Optional[str] = None, init_data=None,
                   beta_floor: float = 0.0, cost_budget: Optional[float] = None,
                   device="cuda") -> Dict[str, List]:
    """Discrete multi-fidelity BO.  ``objective`` follows the
    `data/objectives.py` protocol; ``method`` is UCB, EI, PI or KG (the
    cached acquisition over exported posteriors) or ES or cfKG
    (`bo/strategies.py`).  Returns the record {cost, incumbents,
    operation_time, train_time, acq_time, X, S}: per iteration the total,
    surrogate-training and acquisition seconds (synchronized on the card).

    ``checkpoint_path``: the record and datasets are saved after every
    iteration and reloaded on restart.  ``init_data``: ``(xs, ys)``
    per-fidelity arrays used as the initial design.  UCB's beta is
    ``max(0.2 d log(it + 1.1), beta_floor)`` against a fixed gamma of 0.01;
    ``cost_budget`` makes ES and cfKG cash in once two top-fidelity
    queries would exhaust it."""
    device = resolve_device(device)
    init_index = init_index or {1: 10, 2: 4}
    fidelity_num = objective.total_fidelity_num
    record = {"cost": [], "incumbents": [], "operation_time": [], "train_time": [],
              "acq_time": [], "X": [], "S": []}
    if checkpoint_path and os.path.exists(checkpoint_path):
        loaded, xs, ys = load_bo_state(checkpoint_path)
        record.update(loaded)
        xs, ys = list(xs), list(ys)
        if verbose:
            print(f"resumed from {checkpoint_path} at iteration {len(record['S'])}")
    elif init_data is not None:
        xs = [np.asarray(x, np.float32) for x in init_data[0]]
        ys = [np.asarray(y, np.float32).reshape(len(x), -1) for x, y in zip(xs, init_data[1])]
    else:
        xs, ys = objective.initiate_data(init_index, seed)
    bounds = np.asarray(objective.search_range[: objective.x_dim], float)

    for it in range(len(record["S"]), bo_iterations):
        t0 = synced_time(device)
        model, dm = fit_surrogate(objective, xs, ys, model_name, train_iters, train_lr, device)
        t1 = synced_time(device)
        f_best = float(max(np.max(y) for y in ys))
        beta = 0.2 * objective.x_dim
        if method == "UCB":
            # the reference's MF-GP-UCB schedule, near-greedy early; the
            # floor keeps an exploration bonus while it ramps
            beta = max(0.2 * objective.x_dim * math.log(it + 1.1), beta_floor)
        if method in ("ES", "cfKG"):
            new_x, new_s = _strategy_step(objective, model, dm, method, it, bo_iterations,
                                          seed, bounds, ys, cost_budget)
        else:
            if gamma is not None:
                g = gamma
            elif method == "UCB":
                g = [0.01] * fidelity_num  # the reference's fixed escalation threshold
            else:
                g = [1.0 / (it + 1)] * fidelity_num
            gens = [generator(seed, it, s) for s in range(fidelity_num)]
            new_x, new_s, _, _ = acquire(model, dm, method, beta, f_best, bounds, g,
                                         acq_iterations, acq_lr, generators=gens)
        t2 = synced_time(device)

        new_y = objective.get_data(new_x, new_s + 1)
        xs[new_s] = np.concatenate([xs[new_s], new_x], axis=0)
        ys[new_s] = np.concatenate([ys[new_s], new_y.reshape(1, -1)], axis=0)

        record["X"].append(new_x.ravel().tolist())
        record["S"].append(int(new_s))
        record["cost"].append(objective.cost.compute_model_cost(ys))
        record["incumbents"].append(float(np.max(ys[-1])))
        record["operation_time"].append(time.time() - t0)
        record["train_time"].append(t1 - t0)
        record["acq_time"].append(t2 - t1)
        if checkpoint_path:
            save_bo_state(checkpoint_path, record, xs, ys)
        if verbose:
            print(f"iter {it}: x={new_x.ravel()}, s={new_s}, "
                  f"incumbent={record['incumbents'][-1]:.4f}, cost={record['cost'][-1]:.0f}")
    return record
