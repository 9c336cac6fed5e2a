"""Hyperparameter training: Adam with the NaN last-good rollback, restarts.

Port of `fidelityfusion_tpu/train/fit.py` (`adam_scan`, `_frozen_mask`,
`fit`, `fit_restarts`, `gp_restart_batch`, `LADDER_FACTORS`,
`stack_params`, `perturb_params`).  The JAX `lax.scan` becomes a Python
loop that keeps every value on the device (no host sync per step), and
`vmap` over restarts becomes a leading batch dimension R on every
parameter leaf: the loss returns one value per restart, and the rollback
decides per restart.

Adam is written out to match `optax.adam(lr)`: b1 0.9, b2 0.999, eps 1e-8,
bias-corrected moments, update ``-lr * mu_hat / (sqrt(nu_hat) + eps)``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from fidelityfusion_tpu_torch.ops.kernels import median_heuristic, trainable_mask
from fidelityfusion_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

B1, B2, EPS = 0.9, 0.999, 1e-8
LADDER_FACTORS = (1.0, 0.5, 0.25, 0.125, 0.0625, 2.0, 4.0)


class FitResult(NamedTuple):
    params: dict
    losses: torch.Tensor  # (*batch, steps)


def _frozen_mask(params) -> dict:
    """True for trainable leaves; leaves under keys starting with "_" are
    frozen constants."""
    return trainable_mask(None, params)


def _bcast(flag, leaf):
    """A (*batch) tensor shaped to broadcast against a (*batch, ...) leaf."""
    return flag.reshape(flag.shape + (1,) * (leaf.ndim - flag.ndim))


def adam_scan(loss_fn: Callable, p0, lr: float, steps: int, trainable=None,
              loss_args=()):
    """``steps`` Adam updates of ``loss_fn(p, *loss_args)`` with the NaN
    last-good rollback: a step whose loss or update is not finite resets
    that restart's params and optimizer state to the last snapshot whose
    loss was verified finite (the JAX package's `adam_scan`).

    Returns ``(p_final, good_p, losses)``: ``p_final`` is one
    never-evaluated update ahead, ``good_p`` the last params whose loss was
    finite, ``losses`` ``(*batch, steps)``, all on the device."""
    flags = (tree_leaves(trainable) if trainable is not None
             else [True] * len(tree_leaves(p0)))
    p = [x.detach() for x in tree_leaves(p0)]
    opt = ([torch.zeros_like(x) for x in p], [torch.zeros_like(x) for x in p], None)
    good_p, good_opt = p, opt
    history = []
    for _ in range(steps):
        ps = [x.detach().requires_grad_(bool(f)) for x, f in zip(p, flags)]
        with torch.enable_grad():
            loss = loss_fn(tree_unflatten(p0, ps), *loss_args)
            live = [x for x, f in zip(ps, flags) if f]
            grads = torch.autograd.grad(loss.sum(), live, allow_unused=True)
        loss = loss.detach()
        history.append(loss)
        grads = iter(grads)
        mu, nu, count = opt
        if count is None:  # the batch shape is the loss's
            count = torch.zeros_like(loss)
            opt = good_opt = (mu, nu, count)
        count_n = count + 1
        one = torch.ones((), dtype=loss.dtype, device=loss.device)
        bc1 = 1 - torch.pow(one * B1, count_n)
        bc2 = 1 - torch.pow(one * B2, count_n)
        finite = torch.isfinite(loss)
        new_p, new_mu, new_nu = [], [], []
        for x, m, v, f in zip(p, mu, nu, flags):
            g = next(grads) if f else None
            if g is None:
                g = torch.zeros_like(x)
            m = (1 - B1) * g + B1 * m
            v = (1 - B2) * g ** 2 + B2 * v
            upd = (m / _bcast(bc1, m)) / (torch.sqrt(v / _bcast(bc2, v)) + EPS) * (-lr)
            finite = finite & torch.isfinite(upd).reshape(loss.shape + (-1,)).all(-1)
            new_p.append(x + upd)
            new_mu.append(m)
            new_nu.append(v)

        def sel(new, old):
            return [torch.where(_bcast(finite, a), a, b) for a, b in zip(new, old)]

        def sel_opt(new, old):
            return (sel(new[0], old[0]), sel(new[1], old[1]),
                    torch.where(finite, new[2], old[2]))

        p, good_p, opt, good_opt = (
            sel(new_p, good_p), sel(p, good_p),
            sel_opt((new_mu, new_nu, count_n), good_opt), sel_opt(opt, good_opt),
        )
    losses = torch.stack(history, dim=-1) if history else torch.zeros(0)
    return tree_unflatten(p0, p), tree_unflatten(p0, good_p), losses


def fit(loss_fn: Callable, params: dict, steps: int = 100, lr: float = 1e-2,
        trainable: Optional[dict] = None, loss_args: Optional[tuple] = None) -> FitResult:
    """Minimize ``loss_fn(params, *loss_args)`` with Adam for ``steps``
    steps; returns the last verified-finite params and the loss history."""
    if trainable is None:
        trainable = _frozen_mask(params)
    _, good_p, losses = adam_scan(loss_fn, params, lr, steps, trainable,
                                  tuple(loss_args or ()))
    return FitResult(good_p, losses)


def restart_scores(losses) -> np.ndarray:
    """Each restart's LAST FINITE loss (+inf if none): the loss at the
    params it returns.  ``losses`` is (R, steps)."""
    L = np.asarray(losses.detach().cpu() if torch.is_tensor(losses) else losses,
                   dtype=np.float64)
    finite = np.isfinite(L)
    t_idx = np.arange(L.shape[1])
    last = np.max(np.where(finite, t_idx[None, :], -1), axis=1)
    vals = np.nan_to_num(L, nan=np.inf, posinf=np.inf, neginf=-np.inf)
    picked = np.take_along_axis(vals, np.maximum(last, 0)[:, None], axis=1)[:, 0]
    return np.where(last >= 0, picked, np.inf)


def fit_restarts(loss_fn: Callable, params_batch: dict, steps: int = 100,
                 lr: float = 1e-2, trainable: Optional[dict] = None,
                 loss_args: Optional[tuple] = None):
    """Train every restart of ``params_batch`` (leading axis R) at once and
    pick the restart with the lowest last finite loss.

    The winner is re-verified UNBATCHED (the single-matrix kernel, K2):
    candidates are walked best-first until one gives a finite loss, as in
    the JAX package.  Returns ``(best_params, FitResult(all_params,
    all_losses))`` with ``all_losses`` (R, steps)."""
    if trainable is None:
        trainable = _frozen_mask(params_batch)
    loss_args = tuple(loss_args or ())
    _, params_all, losses_all = adam_scan(loss_fn, params_batch, lr, steps,
                                          trainable, loss_args)
    score = restart_scores(losses_all)
    best_params = None
    with torch.no_grad():
        for idx in np.argsort(score):
            if not np.isfinite(score[idx]):
                break
            cand = tree_map(lambda a, i=int(idx): a[i], params_all)
            if np.isfinite(float(loss_fn(cand, *loss_args))):
                best_params = cand
                break
    if best_params is None:  # no candidate verifies: the argmin
        best = int(np.argmin(score))
        best_params = tree_map(lambda a: a[best], params_all)
    return best_params, FitResult(params_all, losses_all)


def gp_restart_batch(kernel_spec, gp_params: dict, x, n: int,
                     generator: Optional[torch.Generator] = None):
    """``n`` restart initializations of one GP's parameter dict: restart 0
    is ``gp_params``; restart i >= 1 sets the length scales to
    ``LADDER_FACTORS[i-1] * median_heuristic(x)`` and a low noise (a CIGP's
    ``log_beta = 2``, a GPBasic's ``noise_variance = 0.3``): a deterministic
    ladder; restarts past the ladder are random jitter from ``generator``."""
    med = median_heuristic(x)
    out = [gp_params]
    for i in range(1, n):
        if i - 1 < len(LADDER_FACTORS):
            p = dict(gp_params)
            p["kernel"] = kernel_spec.set_lengthscales(
                gp_params["kernel"], med * LADDER_FACTORS[i - 1])
            for key, low in (("log_beta", 2.0), ("noise_variance", 0.3)):
                if key in p:
                    p[key] = torch.tensor([low], device=p[key].device)
            out.append(p)
        else:
            jittered = perturb_params(generator, gp_params, scale=1.0, n=2)
            out.append(tree_map(lambda a: a[1], jittered))
    return out


def stack_params(params_list):
    """Stack same-structure trees along a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), params_list[0], *params_list[1:])


def perturb_params(generator: Optional[torch.Generator], params: dict,
                   scale: float = 1.0, n: int = 1):
    """``n`` copies of ``params`` stacked on a new leading axis, copies 1..n-1
    with N(0, scale^2) noise from ``generator`` (copy 0 is unperturbed)."""

    def noisy(a):
        noise = torch.randn(a.shape, generator=generator, dtype=a.dtype)
        return a + scale * noise.to(a.device)

    copies = [params] + [tree_map(noisy, params) for _ in range(1, n)]
    return stack_params(copies)
